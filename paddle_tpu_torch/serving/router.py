"""Replica router: health-checked failover across N serving engines — the
port's copy of paddle_tpu/serving/router.py.

One engine is one blast radius: a crash kills every stream it owns, and
a service of many users needs many engines behind one door. This module
is that door's brain — a :class:`ReplicaRouter` fronting N engine
replicas, each on its own dedicated step thread (the
same single-owner step-loop idiom as :class:`~paddle_tpu_torch.serving.http.
HTTPFrontDoor`; the HTTP front door remains the wire-level shape, the
router is the placement/failover layer behind it). Four pillars:

- **Placement** — prefix-affinity first: prompts are scored against a
  per-replica shadow of the SAME block-granular token keys the radix
  prefix cache indexes (``tuple(prompt[b*bs:(b+1)*bs])`` per block), so
  requests sharing a system prompt stick to the replica whose trie
  already holds it and pay a near-zero suffix prefill instead of a full
  one. With no affinity signal, placement falls back to tenant-aware
  least-loaded balancing using admission's token-cost model (``prompt +
  max_new_tokens`` outstanding per replica, per tenant first, total as
  the tiebreak). The router sheds (:class:`ShedError` → HTTP 503 +
  Retry-After at the front door) only when NO healthy replica admits
  the request — a single replica's bounded queue is not the cluster's.

- **Health** — every replica step thread stamps a step-progress
  heartbeat (and guards each engine step under the installed
  :mod:`~paddle_tpu_torch.distributed.watchdog`, so a wedged device call
  still trips process-level hang detection). Heartbeat age drives a
  typed state machine ``healthy → suspect → dead`` (plus ``draining`` /
  ``drained``): suspect replicas stop receiving new work, dead ones
  trigger failover. Age alone demotes at most one level per
  :meth:`check` tick (healthy → suspect, then suspect → dead on a
  SECOND stale observation), so a clock step or VM pause cannot
  mass-kill replicas whose threads are fine; a dead step thread is
  fatal immediately. The dead state is a circuit breaker: a recovered
  replica re-enters through ``half_open`` — after
  ``FLAGS_router_halfopen_s`` with a fresh heartbeat it receives ONE
  probe request, and only a cleanly finished probe closes the circuit
  back to ``healthy``. No restart of the router required.

- **Failover with exactly-once resume** — the router records every
  stream's delivered-token count. When a replica dies mid-stream, each
  in-flight request re-dispatches to a healthy replica with ``prompt +
  delivered`` as the new prompt and the remaining token budget — on a
  warm replica the prefix cache makes the replay near-free. Late
  emissions from the dead replica (a zombie thread whose heartbeat
  merely stalled) are deduped at the router by ownership: only the
  stream's CURRENT (replica, engine-rid) owner may append tokens, and
  greedy determinism then guarantees the resumed stream is
  token-identical to an uninterrupted run — test-enforced, never
  best-effort. Re-dispatch and replica
  bootstrap go through :func:`~paddle_tpu_torch.distributed.resilience.retry.
  retry_call` (exponential backoff, full jitter).

- **Per-replica drain** — :meth:`ReplicaRouter.begin_drain` steers new
  traffic away from one replica and lets its in-flight streams finish;
  stragglers past ``FLAGS_router_drain_s`` migrate to healthy replicas
  through the SAME resume path (terminal reason ``drained`` on the old
  replica, token-identical continuation on the new one). A drained
  replica's ledger must read ``free + cached == total`` — zero orphaned
  blocks. :meth:`drain_all` composes with the front door's SIGTERM
  whole-process drain: it drains every replica and then runs the
  watchdog emergency hooks, same registry as the front door and the
  train loop.

Threading model: each replica's step thread OWNS its engine — the
router never touches an engine off its thread. Submissions and
cancellations travel to the step thread through a per-replica op deque
(futures travel back); emitted tokens and terminal reasons route back
to router-owned stream records inside the step thread's loop. The
router's own mutable maps are guarded by one lock. Health transitions
run inside :meth:`check` — called by the optional monitor thread, by
any caller (a chaos harness), or manually with an injected clock in
tests.

Exactly-once semantics, precisely: a stream's tokens are appended only
by its current owner; tokens a replica emits before the submitting
thread has registered the stream (the replica acks a submit and may
step at once — a prefill-role engine emits its first token in that very
step) are held per replica and handed to the stream when it registers,
where the reference drops them (and its stream then re-prefills one
token short, or ends one token short); failover re-dispatches ``prompt
+ delivered``
so the overlap is replayed as PREFILL (never re-emitted); terminal
bookkeeping happens exactly once per router id, into exactly one of
``{finished, shed, deadline_exceeded, client_disconnected, drained}``.
Resume parity is guaranteed for greedy (temperature=0) streams —
sampled streams resume with a fresh key and may diverge (documented,
like any preemption-recompute path would without the KV swap tier).

On one card the replicas' step threads share the device's default
stream: their kernels serialize in launch order (a cooperative
mega-decode launch never shares the card with another replica's
compute), and only the offload engine's copies run on side streams.

Disaggregated prefill/decode: replicas built with
``LLMEngine(..., role="prefill", relay=...)`` run admission + chunked
prefill only — after the first sampled token the engine spills the
slot's KV blocks bit-exact into the SHARED host relay pool
(:class:`~paddle_tpu_torch.serving.kv_swap.HostKVPool` with
``kind="relay"``) and retires the stream with engine reason
``"handoff"``. The router treats ``handoff`` as a ROUTING event, never
a client terminal: the stream re-dispatches — same exactly-once resume
path as failover — onto a decode-capable replica with
``relay_key=<prefill engine rid>``, whose admission restores the
relayed blocks with one batched h2d scatter instead of re-prefilling.
Greedy streams stay token-identical to a colocated run
(test-enforced). Degradations are counted, never silent: a full relay
or a vanished entry means the decode replica re-prefills the
handed-off context (``serving_disagg_handoffs_total{outcome=
"relay_full"|"missing"}``); a prefill replica dying mid-handoff fails
over through the normal from-prompt resume and its orphaned relay
entry is discarded; no decode-capable replica left sheds the stream.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from .. import observability as _obs
from ..distributed import watchdog as _watchdog
from ..distributed.resilience.retry import retry_call
from ..framework.flags import define_flag, get_flag
from ..observability import flight_recorder as _flight
from ..observability import request_trace as _rt
from ..observability.catalog import instrument as _instrument
from .admission import ShedError
from .resilient import ResilientEngine

__all__ = ["ReplicaRouter", "Replica"]

define_flag("router_suspect_s", 2.0,
            "replica heartbeat age after which the router stops placing "
            "new requests on it (healthy -> suspect)")
define_flag("router_dead_s", 6.0,
            "replica heartbeat age after which the router declares it "
            "dead and fails its in-flight streams over (suspect -> "
            "dead; also entered immediately on a crashed step thread)")
define_flag("router_halfopen_s", 2.0,
            "circuit-breaker re-probe delay: seconds after death before "
            "a replica with a fresh heartbeat is offered ONE probe "
            "request (dead -> half_open; a finished probe closes the "
            "circuit back to healthy)")
define_flag("router_drain_s", 15.0,
            "per-replica drain budget: seconds in-flight streams may "
            "keep running on a draining replica before they migrate to "
            "a healthy one via the resume path")

_M_DISPATCH = _instrument("serving_router_dispatch_total")
_M_AFFINITY = _instrument("serving_router_affinity_total")
_M_SHED = _instrument("serving_router_shed_total")
_M_FAILOVERS = _instrument("serving_router_failovers_total")
_M_RESUMED = _instrument("serving_router_resumed_streams_total")
_M_DEDUP = _instrument("serving_router_dedup_drops_total")
_M_TRANSITIONS = _instrument("serving_router_state_transitions_total")
_M_HEALTHY = _instrument("serving_router_healthy_replicas")

# terminal reasons a router stream may land in — same contract as the
# engine's finish_reasons, shed included (router-level or replica-level).
# The engine-level "handoff" reason (disagg prefill replicas) is NOT
# here on purpose: it is a routing event — the stream resumes on a
# decode replica and still ends in exactly one of these.
TERMINAL_REASONS = frozenset(("finished", "shed", "deadline_exceeded",
                              "client_disconnected", "drained"))

# states that may receive NEW placements ("half_open" only via the
# explicit probe slot — see _place)
_PLACEABLE = ("healthy",)


class _Future:
    """Tiny cross-thread future: a replica thread resolves what a
    router-side caller waits on (no asyncio on either side)."""

    __slots__ = ("_ev", "value", "error")

    def __init__(self):
        self._ev = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None

    def set(self, value=None, error: Optional[BaseException] = None):
        self.value, self.error = value, error
        self._ev.set()

    def wait(self, timeout: Optional[float]):
        if not self._ev.wait(timeout):
            raise TimeoutError("replica op timed out")
        if self.error is not None:
            raise self.error
        return self.value


class _StreamRec:
    """Router-side record of one client stream across replica moves."""

    __slots__ = ("rid", "prompt", "kw", "tenant", "max_new", "delivered",
                 "replica", "engine_rid", "resumes", "migrating",
                 "cancelled", "done", "charged", "relay_key")

    def __init__(self, rid: int, prompt: List[int], kw: Dict):
        self.rid = rid
        self.prompt = list(prompt)
        self.kw = dict(kw)
        self.tenant = str(kw.get("tenant", "default"))
        self.max_new = int(kw.get("max_new_tokens", 64))
        self.delivered: List[int] = []
        self.charged = 0.0   # admission-cost tokens charged at dispatch
        self.replica: Optional[str] = None      # current owner name
        self.engine_rid: Optional[int] = None   # rid on that owner
        self.resumes = 0
        self.migrating = False   # drain: next terminal resumes elsewhere
        self.cancelled = False   # client cancel: never resurrect
        self.relay_key = None    # disagg: relay entry id (prefill erid)
        self.done = threading.Event()


class Replica:
    """One engine replica on its dedicated step thread.

    The thread owns the engine exclusively (the engine's pipelined state
    machine is single-owner per step); everything else reaches it via
    the op deque. ``hb`` is the step-progress heartbeat the router's
    health machine reads — stamped from the ROUTER's clock so tests can
    drive the whole state machine with an injected ``now_fn``.
    """

    def __init__(self, name: str, engine, router: "ReplicaRouter",
                 resilient: bool = True):
        self.name = name
        # crash recovery stays per-replica: a readback crash inside one
        # replica is salvaged there, invisible to the router
        self.raw = (engine.engine if isinstance(engine, ResilientEngine)
                    else engine)
        # disagg: placement honors the engine's role — "prefill"
        # replicas hand every stream off after prefill, "decode"
        # replicas are last-resort prefill targets, "both" (default)
        # serves the whole lifecycle
        self.role = getattr(self.raw, "role", "both")
        self.stepper = (engine if isinstance(engine, ResilientEngine)
                        else ResilientEngine(engine) if resilient
                        else engine)
        self._router = router
        self._ops: List = []            # guarded by _ops_lock
        self._ops_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._killed = False            # chaos: sudden-death switch
        self.hb_frozen = False          # test hook: stall the heartbeat
        self.crashed: Optional[str] = None
        self.state = "healthy"
        self.hb = router._now()
        self.t_dead: Optional[float] = None
        self.probe_pending = False      # half_open: one probe allowed
        self.probe_rid: Optional[int] = None
        # ownership + affinity shadow (guarded by the router lock)
        self.owned: Dict[int, int] = {}        # engine rid -> router rid
        self.ghosts: Set[int] = set()          # abandoned engine rids
        # tokens emitted for an engine rid before its submitter registered
        # it (the replica can ack a submit and step before the submitting
        # thread takes the lock); _dispatch hands them to the stream
        self.early: Dict[int, List[int]] = {}
        self.prefix_keys: Set[Tuple[int, ...]] = set()
        # tenant -> outstanding admission-cost tokens (prompt + max_new)
        self.load: Dict[str, float] = {}
        self.dispatches = 0
        self.steps = 0
        self._thread: Optional[threading.Thread] = None

    # -- cross-thread ops --------------------------------------------------
    def enqueue(self, op) -> None:
        with self._ops_lock:
            self._ops.append(op)
        self._wake.set()

    def _fail_pending_ops(self, exc: BaseException) -> None:
        with self._ops_lock:
            ops, self._ops = self._ops, []
        for op in ops:
            if op[0] == "submit":
                op[3].set(error=exc)

    def _run_ops(self) -> None:
        while True:
            with self._ops_lock:
                if not self._ops:
                    return
                op = self._ops.pop(0)
            if op[0] == "submit":
                _k, prompt, kw, fut = op
                try:
                    fut.set(self.raw.add_request(prompt, **kw))
                except BaseException as e:
                    fut.set(error=e)
            elif op[0] == "cancel":
                _k, erid, reason = op
                self.raw.cancel_request(erid, reason=reason)

    # -- the step loop -----------------------------------------------------
    def _loop(self) -> None:
        router = self._router
        # fleet scoping: everything this step thread touches — every
        # engine counter/gauge/histogram AND every span — lands under a
        # {replica=<name>} label, so one process registry carries N
        # attributable replicas. Metric mutators still short-circuit on
        # the enabled() check first, so the disabled path is unchanged.
        scope = _obs.get_registry().scoped(replica=self.name)
        scope.activate()
        try:
            while not self._stop:
                if self._killed:
                    raise RuntimeError(
                        f"replica {self.name}: killed (chaos)")
                if not self.hb_frozen:
                    self.hb = router._now()
                self._run_ops()
                if self.raw.has_work():
                    # a wedged device call on THIS replica still trips
                    # the process watchdog (no-op when none installed)
                    with _watchdog.guarded(f"router-{self.name}-step"):
                        emitted = self.stepper.step()
                    self.steps += 1
                    if not self.hb_frozen:   # step progress IS the pulse
                        self.hb = router._now()
                    router._on_emitted(self, emitted)
                    router._on_terminals(self)
                    if router.step_hook is not None:
                        router.step_hook(self.name, self.raw)
                else:
                    router._on_terminals(self)
                    self._wake.wait(router.idle_wait)
                    self._wake.clear()
        except BaseException as e:      # sudden death — the chaos case
            self.crashed = f"{type(e).__name__}: {e}"
            self._fail_pending_ops(
                RuntimeError(f"replica {self.name} died: {self.crashed}"))
            _flight.record("router_replica_died", replica=self.name,
                           error=self.crashed[:160])
            router._note_crash(self)
        finally:
            scope.deactivate()
            self._fail_pending_ops(
                RuntimeError(f"replica {self.name} stopped"))

    def start(self) -> None:
        self._stop = False
        self._killed = False
        self.crashed = None
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"router-replica-{self.name}")
        self._thread.start()

    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def kill(self) -> None:
        """Chaos hook: sudden replica death (preemption/OOM stand-in).
        The step thread dies at its next loop boundary; the engine's
        state is abandoned mid-flight until :meth:`ReplicaRouter.
        revive_replica` recovers it."""
        self._killed = True
        self._wake.set()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout)


class ReplicaRouter:
    """Health-checked placement/failover layer over N engine replicas.

    ``engines`` are freshly constructed :class:`LLMEngine` instances
    (same params/config; each is wrapped in :class:`ResilientEngine`
    unless ``resilient=False`` or already wrapped). ``now_fn`` is the
    injectable clock every health/drain decision reads — tests drive
    the full state machine without sleeping. ``step_hook(name, engine)``
    runs after every replica step (the chaos harness's per-replica
    ledger assertion point). ``monitor_interval > 0`` starts a
    background thread calling :meth:`check` on a real-time cadence;
    leave 0 to call it yourself.
    """

    def __init__(self, engines: Sequence, names: Optional[Sequence[str]]
                 = None, now_fn: Callable[[], float] = time.monotonic,
                 step_hook: Optional[Callable] = None,
                 idle_wait: float = 0.005, resilient: bool = True,
                 suspect_s: Optional[float] = None,
                 dead_s: Optional[float] = None,
                 halfopen_s: Optional[float] = None,
                 drain_s: Optional[float] = None,
                 monitor_interval: float = 0.0,
                 retry_sleep: Callable[[float], None] = time.sleep,
                 op_timeout: float = 120.0):
        if not engines:
            raise ValueError("ReplicaRouter needs at least one replica")
        self._now = now_fn
        self.step_hook = step_hook
        self.idle_wait = float(idle_wait)
        self.suspect_s = (float(get_flag("router_suspect_s"))
                          if suspect_s is None else float(suspect_s))
        self.dead_s = (float(get_flag("router_dead_s"))
                       if dead_s is None else float(dead_s))
        self.halfopen_s = (float(get_flag("router_halfopen_s"))
                           if halfopen_s is None else float(halfopen_s))
        self.drain_s = (float(get_flag("router_drain_s"))
                        if drain_s is None else float(drain_s))
        self._retry_sleep = retry_sleep
        self._op_timeout = float(op_timeout)
        self._lock = threading.RLock()
        self._streams: Dict[int, _StreamRec] = {}
        self._next_rid = itertools.count()
        self.results: Dict[int, List[int]] = {}
        self.finish_reasons: Dict[int, str] = {}
        self.failovers = 0
        self.resumed_streams = 0
        self.handoff_resumes = 0   # disagg: prefill→decode stream moves
        self.dedup_drops = 0
        self.affinity_hits = 0
        self.affinity_misses = 0
        self.router_sheds = 0
        names = list(names) if names is not None else \
            [f"r{i}" for i in range(len(engines))]
        if len(names) != len(engines):
            raise ValueError("names/engines length mismatch")
        self.replicas: Dict[str, Replica] = {}
        for i, (name, eng) in enumerate(zip(names, engines)):
            rep = Replica(name, eng, self, resilient=resilient)
            # disjoint engine-rid spaces across replicas: request traces
            # land in ONE process-global tracer, and obs_dump's replica
            # column is only meaningful when ids never collide. The base
            # is 1-indexed so no replica shares the 0-based space that
            # standalone engines (reference replays, warmups) mint from —
            # a collision there makes tracer.get() resolve a router
            # stream's rid to the bystander's newer timeline
            rep.raw._next_id += (i + 1) * 1_000_000
            self.replicas[name] = rep
        self._drain_t0: Dict[str, float] = {}
        self._monitor_interval = float(monitor_interval)
        self._monitor: Optional[threading.Thread] = None
        self._stopping = False
        # fleet federation: the aggregator holds us weakly and
        # carves one per-replica snapshot out of the scoped registry for
        # /fleet/* — latest router wins the singleton
        from ..observability import fleet as _fleet
        _fleet.get_aggregator().attach_router(self)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ReplicaRouter":
        """Boot every replica step thread. Bootstrap goes through
        retry_call — a replica whose thread fails to come up (transient
        resource pressure) is retried with full-jitter backoff rather
        than failing the whole router."""
        for rep in self.replicas.values():
            retry_call(self._boot_replica, rep, retries=3,
                       base_delay=0.05, exceptions=(RuntimeError,),
                       sleep=self._retry_sleep)
        if self._monitor_interval > 0:
            self._monitor = threading.Thread(
                target=self._monitor_loop, daemon=True,
                name="router-monitor")
            self._monitor.start()
        return self

    def _boot_replica(self, rep: Replica) -> None:
        rep.start()
        if not rep.alive():
            raise RuntimeError(f"replica {rep.name} failed to start")

    def _monitor_loop(self) -> None:
        while not self._stopping:
            time.sleep(self._monitor_interval)
            try:
                self.check()
            except Exception as e:        # pragma: no cover — monitor
                _flight.record("router_monitor_error",  # must not die
                               error=repr(e)[:160])

    def stop(self) -> None:
        self._stopping = True
        for rep in self.replicas.values():
            rep.stop()
        if self._monitor is not None:
            self._monitor.join(5)

    # -- introspection -----------------------------------------------------
    def states(self) -> Dict[str, str]:
        with self._lock:
            return {name: rep.state
                    for name, rep in self.replicas.items()}

    def live_streams(self) -> int:
        with self._lock:
            return sum(1 for rec in self._streams.values()
                       if not rec.done.is_set())

    def has_work(self) -> bool:
        return self.live_streams() > 0

    # -- placement ---------------------------------------------------------
    @staticmethod
    def _block_keys(prompt: List[int], bs: int) -> List[Tuple[int, ...]]:
        """The radix cache's block-granular token keys for ``prompt``
        (full blocks only — identical to PrefixCache's node keys)."""
        return [tuple(prompt[b * bs:(b + 1) * bs])
                for b in range(len(prompt) // bs)]

    def _affinity_score(self, rep: Replica, keys) -> int:
        """Longest run of leading block keys this replica has served —
        the shadow of what its prefix-cache trie holds."""
        n = 0
        for key in keys:
            if key not in rep.prefix_keys:
                break
            n += 1
        return n

    def _note_dispatch(self, rep: Replica, rec: _StreamRec,
                       prompt: List[int], cost: float) -> None:
        bs = rep.raw.bs
        rep.prefix_keys.update(self._block_keys(prompt, bs))
        rec.charged = float(cost)
        rep.load[rec.tenant] = rep.load.get(rec.tenant, 0.0) + cost
        rep.dispatches += 1
        _M_DISPATCH.inc(replica=rep.name)

    def _unload(self, rep: Replica, rec: _StreamRec) -> None:
        left = rep.load.get(rec.tenant, 0.0) - rec.charged
        if left > 1e-9:
            rep.load[rec.tenant] = left
        else:
            rep.load.pop(rec.tenant, None)

    def _place(self, prompt: List[int], tenant: str, exclude: Set[str],
               role_need: str = "prefill"
               ) -> Tuple[List[Replica], Optional[Dict]]:
        """Candidate replicas, best first. Affinity wins when any
        candidate holds >= 1 leading block of the prompt; otherwise a
        pending half-open probe takes the request (the circuit
        breaker's re-probe), then tenant-aware least-loaded order.
        Second return: the placement-audit record (candidate scores,
        loads, decision reason) when observability is on, else None.

        ``role_need`` (disagg): ``"prefill"`` — the stream starts
        with a prefill, which EVERY role can run, but decode-role
        replicas rank last (before affinity: a decode replica's trie
        shadow must not pull fresh prompts onto it); ``"decode"`` — the
        stream resumes from relayed KV, so prefill-role replicas are
        excluded outright (they would hand off again, forever)."""
        with self._lock:
            cands = [rep for rep in self.replicas.values()
                     if rep.state in _PLACEABLE
                     and rep.name not in exclude
                     and not (role_need == "decode"
                              and rep.role == "prefill")]
            probe = next((rep for rep in self.replicas.values()
                          if rep.state == "half_open" and
                          rep.probe_pending and rep.name not in exclude
                          and not (role_need == "decode"
                                   and rep.role == "prefill")),
                         None)
            if not cands and probe is None:
                return [], None
            bs = cands[0].raw.bs if cands else probe.raw.bs
            keys = self._block_keys(prompt, bs)
            scored = sorted(
                cands,
                key=lambda rep: (role_need == "prefill"
                                 and rep.role == "decode",
                                 -self._affinity_score(rep, keys),
                                 rep.load.get(tenant, 0.0),
                                 sum(rep.load.values()),
                                 rep.name))
            best_aff = (self._affinity_score(scored[0], keys)
                        if scored else 0)
            reason = ("affinity" if best_aff > 0
                      else "half_open_probe" if probe is not None
                      else "least_loaded")
            audit = None
            if _obs.enabled():
                audit = {"tenant": tenant, "blocks": len(keys),
                         "reason": reason,
                         "candidates": [
                             {"replica": rep.name,
                              "affinity": self._affinity_score(rep, keys),
                              "tenant_load":
                                  round(rep.load.get(tenant, 0.0), 1),
                              "load": round(sum(rep.load.values()), 1)}
                             for rep in scored]}
            if best_aff > 0:
                self.affinity_hits += 1
                _M_AFFINITY.inc(outcome="hit")
                # the probe still rides along as a fallback candidate
                return (scored + ([probe] if probe is not None else []),
                        audit)
            if keys:
                self.affinity_misses += 1
                _M_AFFINITY.inc(outcome="miss")
            if probe is not None:
                return [probe] + scored, audit
            return scored, audit

    # -- submission --------------------------------------------------------
    def submit(self, prompt: List[int], **kw) -> int:
        """Mint a router request id and dispatch it. Raises
        :class:`ShedError` (with the minted id and the LAST replica's
        shed reason) only when no healthy replica admitted it — the
        router-level 503. Engine-side validation errors propagate."""
        rid = next(self._next_rid)
        rec = _StreamRec(rid, prompt, kw)
        with self._lock:
            self._streams[rid] = rec
        try:
            self._dispatch(rec, list(rec.prompt), rec.kw,
                           exclude=set())
        except ShedError as e:
            with self._lock:
                self._terminal(rec, "shed")
            self.router_sheds += 1
            _M_SHED.inc()
            raise ShedError(e.reason, rid) from None
        return rid

    def _dispatch(self, rec: _StreamRec, prompt: List[int], kw: Dict,
                  exclude: Set[str], role_need: str = "prefill") -> None:
        """Place ``rec`` on the best candidate, walking down the
        preference order when a replica sheds or dies mid-op. Raises
        ShedError when every candidate refused."""
        last: Optional[ShedError] = None
        tried = set(exclude)
        cands, audit = self._place(prompt, rec.tenant, tried, role_need)
        if not cands:
            raise ShedError("no_healthy_replica")
        for rep in cands:
            fut = _Future()
            rep.enqueue(("submit", list(prompt), dict(kw), fut))
            try:
                erid = fut.wait(self._op_timeout)
            except ShedError as e:
                last = e
                tried.add(rep.name)
                continue
            except (RuntimeError, TimeoutError):
                # the replica died (or wedged) under the op — health
                # will catch it; try the next candidate
                tried.add(rep.name)
                continue
            with self._lock:
                rec.replica = rep.name
                rec.engine_rid = erid
                rep.owned[erid] = rec.rid
                rec.delivered.extend(rep.early.pop(erid, ()))
                if rep.state == "half_open" and rep.probe_pending:
                    rep.probe_pending = False
                    rep.probe_rid = erid
                self._note_dispatch(
                    rep, rec, prompt,
                    len(prompt) + int(kw.get("max_new_tokens",
                                             rec.max_new)))
            if _obs.enabled():
                _rt.get_request_tracer().annotate(erid, replica=rep.name)
                if audit is not None:
                    from ..observability import fleet as _fleet
                    _fleet.get_placement_log().record(
                        rid=rec.rid, chosen=rep.name,
                        skipped=len(tried) - len(exclude),
                        resume=rec.resumes > 0, **audit)
                    _flight.record("router_placement", rid=rec.rid,
                                   chosen=rep.name,
                                   reason=audit["reason"])
            return
        raise last if last is not None else ShedError("no_healthy_replica")

    def cancel(self, rid: int, reason: str = "client_disconnected") -> None:
        """Client-side cancellation of a router stream: forwarded to the
        owning replica; already-terminal ids no-op (the engine's own
        idempotence guard counts the race)."""
        with self._lock:
            rec = self._streams.get(rid)
            if rec is None or rec.done.is_set():
                return
            rec.cancelled = True
            rep = (self.replicas.get(rec.replica)
                   if rec.replica is not None else None)
            erid = rec.engine_rid
        if rep is not None and erid is not None:
            rep.enqueue(("cancel", erid, reason))

    # -- results -----------------------------------------------------------
    def wait(self, rid: int, timeout: Optional[float] = None) -> List[int]:
        """Block until ``rid`` reaches a terminal reason; return its full
        delivered token stream (``results[rid]``)."""
        rec = self._streams.get(rid)
        if rec is None:
            raise KeyError(f"unknown router request {rid}")
        if not rec.done.wait(timeout):
            raise TimeoutError(f"router request {rid} not terminal "
                               f"after {timeout}s")
        return self.results[rid]

    def wait_all(self, timeout: float = 120.0) -> bool:
        deadline = time.monotonic() + timeout
        for rec in list(self._streams.values()):
            if not rec.done.wait(max(0.0, deadline - time.monotonic())):
                return False
        return True

    # -- step-thread callbacks --------------------------------------------
    def _on_emitted(self, rep: Replica, emitted) -> None:
        if not emitted:
            return
        with self._lock:
            for erid, tok in emitted:
                rrid = rep.owned.get(erid)
                if rrid is None:
                    if erid in rep.ghosts:
                        # a zombie replica (stalled, declared dead,
                        # failed over) kept emitting: the stream moved,
                        # these tokens were replayed elsewhere — drop
                        # and count, never double-deliver
                        self.dedup_drops += 1
                        _M_DEDUP.inc()
                    else:
                        # not registered yet: kept for its stream
                        rep.early.setdefault(erid, []).append(int(tok))
                    continue
                self._streams[rrid].delivered.append(int(tok))

    def _on_terminals(self, rep: Replica) -> None:
        eng = rep.raw
        resumes: List[_StreamRec] = []
        handoffs: List[Tuple[_StreamRec, int]] = []
        with self._lock:
            for erid in list(rep.owned):
                reason = eng.finish_reasons.get(erid)
                if reason is None:
                    continue
                rrid = rep.owned.pop(erid)
                rec = self._streams[rrid]
                self._unload(rep, rec)
                if erid == rep.probe_rid:
                    rep.probe_rid = None
                    if rep.state == "half_open":
                        if reason in ("finished", "handoff"):
                            # a prefill-role replica never finishes a
                            # stream itself — a clean handoff is its
                            # proof of life
                            self._transition(rep, "healthy")
                        else:
                            # shed/deadline proves nothing either way:
                            # offer another probe
                            rep.probe_pending = True
                if reason == "handoff":
                    # disagg: the prefill leg is done — its KV sits
                    # in the shared relay under this engine rid. The
                    # stream continues on a decode-capable replica; this
                    # is never a client-visible terminal.
                    if rec.cancelled:
                        relay = self._relay()
                        if relay is not None:
                            relay.discard(erid)
                        self._terminal(rec, "client_disconnected")
                    else:
                        handoffs.append((rec, erid))
                    continue
                if rec.migrating and not rec.cancelled \
                        and reason == "drained":
                    rec.migrating = False
                    resumes.append(rec)
                    continue
                self._terminal(rec, reason)
        for rec in resumes:
            self._resume(rec, exclude={rep.name})
        for rec, erid in handoffs:
            self._resume(rec, exclude=set(), relay_key=erid,
                         role_need="decode")

    def _terminal(self, rec: _StreamRec, reason: str) -> None:
        """Exactly-once terminal bookkeeping (caller holds the lock)."""
        if rec.done.is_set():
            return
        self.results[rec.rid] = list(rec.delivered)
        self.finish_reasons[rec.rid] = reason
        rec.done.set()

    # -- health ------------------------------------------------------------
    def _transition(self, rep: Replica, state: str) -> None:
        if rep.state == state:
            return
        _flight.record("router_replica_state", replica=rep.name,
                       prev=rep.state, state=state)
        _M_TRANSITIONS.inc(state=state)
        rep.state = state
        if state == "dead":
            rep.t_dead = self._now()
        if _obs.enabled():
            _M_HEALTHY.set(sum(1 for r in self.replicas.values()
                               if r.state == "healthy"))

    def _note_crash(self, rep: Replica) -> None:
        """Called from a dying replica thread: open the circuit and fail
        its streams over immediately — no need to wait for the
        heartbeat to age out."""
        with self._lock:
            already_dead = rep.state == "dead"
            if not already_dead:
                self._transition(rep, "dead")
        if not already_dead:
            self._failover(rep)

    def check(self) -> Dict[str, str]:
        """One health/drain tick: age heartbeats through the state
        machine, fail dead replicas' streams over, re-probe recovered
        ones (circuit half-open), migrate drain stragglers, finalize
        drains. Returns the post-tick state map. Uses ``now_fn``
        exclusively — inject a clock to drive transitions in tests."""
        now = self._now()
        failover: List[Replica] = []
        migrate: List[Replica] = []
        with self._lock:
            for rep in self.replicas.values():
                age = now - rep.hb
                if rep.state in ("draining", "drained"):
                    if rep.state == "draining":
                        if not rep.alive() or age >= self.dead_s:
                            # died mid-drain: same as any other death
                            self._transition(rep, "dead")
                            if rep.owned:
                                failover.append(rep)
                        elif not rep.owned and not rep.raw.has_work():
                            self._transition(rep, "drained")
                        elif now - self._drain_t0[rep.name] \
                                >= self.drain_s and rep.owned:
                            migrate.append(rep)
                    continue
                if rep.state == "dead":
                    # circuit breaker: a fresh heartbeat (live thread)
                    # after the re-probe delay earns ONE half-open probe
                    if rep.alive() and rep.crashed is None \
                            and age < self.suspect_s \
                            and now - rep.t_dead >= self.halfopen_s:
                        self._transition(rep, "half_open")
                        rep.probe_pending = True
                    continue
                if rep.state == "half_open":
                    if not rep.alive() or age >= self.dead_s:
                        # the probe window failed: re-open
                        rep.probe_pending = False
                        self._transition(rep, "dead")
                        if rep.owned:
                            failover.append(rep)
                    continue
                # healthy / suspect. Thread death is immediately fatal;
                # heartbeat AGE can only demote one level per tick
                # (healthy -> suspect, suspect -> dead): a single stale
                # observation after a clock step or VM pause must not
                # mass-kill replicas whose threads are fine — they get
                # one tick to stamp a fresh pulse and recover
                if not rep.alive():
                    self._transition(rep, "dead")
                    if rep.owned:
                        failover.append(rep)
                elif age >= self.dead_s and rep.state == "suspect":
                    self._transition(rep, "dead")
                    if rep.owned:
                        failover.append(rep)
                elif age >= self.suspect_s:
                    self._transition(rep, "suspect")
                elif rep.state == "suspect":
                    self._transition(rep, "healthy")
            if _obs.enabled():
                # stamp every tick, not only on transitions: a router
                # that boots healthy and never transitions must still
                # export the true pool size, not the gauge's 0 default
                _M_HEALTHY.set(sum(1 for r in self.replicas.values()
                                   if r.state == "healthy"))
        for rep in failover:
            self._failover(rep)
        for rep in migrate:
            self._migrate_stragglers(rep)
        if _obs.enabled():
            self._slo_tick()
        return self.states()

    def _slo_tick(self) -> None:
        """Fleet SLO burn-rate tick (windowed): sample
        the time-series ring (the router tick keeps history flowing
        even when every engine idles), refresh per-replica attainment
        gauges + breach events, and evaluate the anomaly watchers; with
        FLAGS_obs_fleet_slo_advisory on, a replica burning its windowed
        budget OR firing an advisory watcher (e.g. tok/s divergence vs
        the fleet median) is demoted healthy -> suspect — advisory
        only: placement steers away for a tick, the heartbeat machine
        re-promotes it when its latency recovers, and liveness alone
        still decides dead."""
        from ..observability import fleet as _fleet
        from ..observability import timeseries as _ts

        try:
            _ts.step_tick()
            burning = _fleet.check_slo(list(self.replicas))
            burning |= _ts.get_alert_engine().burning_replicas()
        except Exception as e:      # telemetry must never kill a tick
            _flight.record("router_slo_tick_error", error=repr(e)[:120])
            return
        if not burning or not bool(get_flag("obs_fleet_slo_advisory")):
            return
        with self._lock:
            for name in burning:
                rep = self.replicas.get(name)
                if rep is not None and rep.state == "healthy":
                    _flight.record("router_slo_advisory", replica=name)
                    self._transition(rep, "suspect")

    # -- failover / resume -------------------------------------------------
    def _relay(self):
        """The shared disagg relay pool, discovered from whichever
        replica engine carries one (they all share the SAME pool by
        construction); ``None`` on a non-disagg fleet."""
        for rep in self.replicas.values():
            r = getattr(rep.raw, "relay", None)
            if r is not None:
                return r
        return None

    def _failover(self, rep: Replica) -> None:
        """Re-dispatch every stream the dead replica owned: ``prompt +
        delivered`` becomes the new prompt, the remaining budget the new
        ``max_new_tokens``. The dead replica's engine rids become ghosts
        so late emissions dedupe instead of double-delivering."""
        relay = self._relay()
        with self._lock:
            moved = []
            for erid, rrid in list(rep.owned.items()):
                rep.owned.pop(erid)
                rep.ghosts.add(erid)
                rec = self._streams[rrid]
                self._unload(rep, rec)
                moved.append(rec)
                # a prefill replica dying between relay.put and the
                # router observing "handoff" leaves its spilled KV
                # orphaned under this erid — the stream re-dispatches
                # from the prompt, so the entry is dead weight (no-op
                # when nothing was spilled)
                if relay is not None:
                    relay.discard(erid)
            # its trie is unreachable until revive+recovery clears it
            rep.prefix_keys.clear()
            rep.load.clear()
            rep.early.clear()
        for rec in moved:
            if rec.done.is_set():
                continue
            self.failovers += 1
            _M_FAILOVERS.inc()
            if rec.cancelled:
                with self._lock:
                    self._terminal(rec, "client_disconnected")
                continue
            self._resume(rec, exclude={rep.name})

    def _resume(self, rec: _StreamRec, exclude: Set[str],
                relay_key: Optional[int] = None,
                role_need: str = "prefill") -> None:
        """Exactly-once stream resume on a healthy replica. Greedy
        determinism + the replayed-as-prefill overlap make the resumed
        stream token-identical to an uninterrupted run.

        Disagg: a handoff resume passes ``relay_key`` (the
        prefill replica's engine rid, the relay entry's key) and
        ``role_need="decode"`` — the kw COPY sent to the decode replica
        carries the key, ``rec.kw`` never does (a later failover must
        re-prefill, not chase a consumed relay entry). A plain resume
        (``relay_key=None``) discards any relay entry still parked
        under the stream's old handoff key."""
        remaining = rec.max_new - len(rec.delivered)
        relay = (self._relay()
                 if relay_key is not None or rec.relay_key is not None
                 else None)
        if relay_key is None and rec.relay_key is not None:
            # re-prefilling from the prompt: a relay entry the decode
            # replica never consumed (it died first) is unreachable now
            if relay is not None:
                relay.discard(rec.relay_key)
            rec.relay_key = None
        if remaining <= 0:
            if relay_key is not None and relay is not None:
                relay.discard(relay_key)
            with self._lock:
                self._terminal(rec, "finished")
            return
        prompt = rec.prompt + rec.delivered
        kw = dict(rec.kw)
        kw["max_new_tokens"] = remaining
        if relay_key is not None:
            kw["relay_key"] = relay_key
            rec.relay_key = relay_key
        # an eos the dead replica already emitted would have finished
        # there; the resumed request keeps the same stopping rule
        rec.resumes += 1
        if relay_key is None:
            self.resumed_streams += 1
            _M_RESUMED.inc()
        else:
            self.handoff_resumes += 1
        prev_replica, prev_erid = rec.replica, rec.engine_rid
        try:
            retry_call(self._dispatch, rec, prompt, kw, exclude,
                       role_need, retries=2, base_delay=0.05,
                       exceptions=(TimeoutError,),
                       sleep=self._retry_sleep)
        except ShedError:
            # nowhere to resume: the stream ends in exactly one terminal
            # reason — shed — with its partial tokens delivered. A
            # disagg fleet with no decode-capable replica left lands
            # here (the documented degradation); its relay entry goes
            # with it.
            if relay_key is not None and relay is not None:
                relay.discard(relay_key)
            with self._lock:
                self._terminal(rec, "shed")
            self.router_sheds += 1
            _M_SHED.inc()
        except (ValueError, RuntimeError) as e:
            # resumed prompt no longer fits (model-len/bucket bound) or
            # every candidate died under the op: terminal, never a hang
            if relay_key is not None and relay is not None:
                relay.discard(relay_key)
            _flight.record("router_resume_failed", rid=rec.rid,
                           error=repr(e)[:120])
            with self._lock:
                self._terminal(rec, "shed")
            self.router_sheds += 1
            _M_SHED.inc()
        else:
            # failover-continuous tracing: graft the old leg's
            # timeline onto the resumed engine rid, so the client's ONE
            # stream stays ONE trace — with a structured failover (or
            # disagg-handoff) hop — through the move. Old-rid lookups
            # alias forward; the dead replica's zombie writes hit an
            # unknown rid and no-op.
            if _obs.enabled() and prev_erid is not None:
                grafted = _rt.get_request_tracer().reassign(
                    prev_erid, rec.engine_rid,
                    **{"from": prev_replica, "to": rec.replica,
                       "delivered": len(rec.delivered)})
                _flight.record(
                    "router_handoff" if relay_key is not None
                    else "router_failover", rid=rec.rid,
                    **{"from": prev_replica, "to": rec.replica,
                       "delivered": len(rec.delivered),
                       "trace_grafted": bool(grafted)})

    # -- chaos / recovery hooks -------------------------------------------
    def kill_replica(self, name: str) -> None:
        """Chaos: sudden death of one replica (its step thread dies at
        the next loop boundary; in-flight streams fail over on the
        crash note or the next :meth:`check`)."""
        self.replicas[name].kill()

    def revive_replica(self, name: str) -> None:
        """Bring a dead replica's engine back to a serving state and
        restart its step thread. The circuit stays OPEN: the replica
        re-enters traffic through the half-open probe on a later
        :meth:`check`. Bootstrap goes through retry_call."""
        rep = self.replicas[name]
        if rep.alive():
            raise RuntimeError(f"replica {name} is still running")
        eng = rep.raw
        # drop the abandoned in-flight wave, requeue the slots, clear
        # the trie — then cancel the orphans the router already moved
        # elsewhere (the engine's idempotence guard counts any race
        # with an already-terminal id)
        eng.recover_crashed_step()
        with self._lock:
            ghosts = set(rep.ghosts)
            rep.prefix_keys.clear()
            rep.load.clear()
        for erid in ghosts:
            eng.cancel_request(erid, reason="client_disconnected")
        retry_call(self._boot_replica, rep, retries=3, base_delay=0.05,
                   exceptions=(RuntimeError,), sleep=self._retry_sleep)

    # -- drain -------------------------------------------------------------
    def begin_drain(self, name: str) -> None:
        """Steer new traffic away from one replica; in-flight streams
        keep running. Stragglers past the drain budget migrate to
        healthy replicas via the resume path on a later :meth:`check`."""
        rep = self.replicas[name]
        with self._lock:
            if rep.state in ("draining", "drained", "dead"):
                # dead is already out of rotation with no owned streams
                # (failover moved them); draining a corpse would wedge
                # on its frozen engine's has_work() forever
                return
            self._drain_t0[name] = self._now()
            self._transition(rep, "draining")
        _flight.record("router_drain_begin", replica=name)

    def _migrate_stragglers(self, rep: Replica) -> None:
        """Drain budget blown: cut every stream still on the draining
        replica (terminal reason ``drained`` there) and mark it for
        resume — _on_terminals re-dispatches with prompt + delivered."""
        with self._lock:
            pairs = [(erid, self._streams[rrid])
                     for erid, rrid in rep.owned.items()]
        for erid, rec in pairs:
            if not rec.cancelled:
                rec.migrating = True
            rep.enqueue(("cancel", erid, "drained"))

    def drain_all(self, timeout: float = 60.0) -> bool:
        """Whole-router drain (the front door's SIGTERM shape, one level
        up): drain every replica, wait for the streams to retire, then run
        the watchdog emergency hooks — same registry the front door and
        the train loop flush through."""
        t0 = time.monotonic()
        for name in self.replicas:
            self.begin_drain(name)
        ok = self.wait_all(timeout)
        self.check()
        _watchdog.run_emergency_hooks("router-drain",
                                      time.monotonic() - t0)
        _flight.maybe_dump("sigterm")
        return ok

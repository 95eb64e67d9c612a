"""HTTP/SSE serving front door: the socket-facing edge of the engine — the
port's copy of paddle_tpu/serving/http.py.

The engine's survivability — typed ``ShedError`` for overload,
per-request deadlines, request traces, admission control, swap
preemption, crash recovery — meets the failure modes that arrive over a
socket here: slow readers, mid-stream disconnects, overload bursts,
restarts under load. This module is that last layer: a stdlib-only
asyncio HTTP/1.1 server running
:class:`~paddle_tpu_torch.serving.LLMEngine` (or its
:class:`~paddle_tpu_torch.serving.ResilientEngine` wrapper) on a
dedicated step-loop thread, with robustness wired end to end:

- **Streaming** — ``POST /v1/generate`` emits one SSE ``data:`` frame
  per generated token plus a terminal frame carrying the finish reason
  and the full token list (``"stream": false`` returns one JSON body
  instead). The token stream is byte-identical to a direct engine run:
  frames are built by :func:`sse_token_frame` / :func:`sse_terminal_frame`
  with canonical JSON, so parity is testable at the byte level.
- **Backpressure** — each connection owns a bounded send queue; a slow
  client stalls only its own stream (the engine thread never blocks on
  a socket). Past ``FLAGS_serve_send_queue_hwm`` queued frames for
  longer than ``FLAGS_serve_client_stall_s``, the request is cancelled
  server-side and the connection aborted — one wedged reader cannot
  pin a slot's KV blocks forever.
- **Disconnect cancellation** — a dropped connection (write failure or
  reader EOF) marks the request via ``LLMEngine.cancel_request``; the
  next engine step evicts it through the deadline-eviction path, so its
  slot and KV blocks free within ONE step and its trace closes with the
  ``client_disconnected`` terminal reason.
- **Typed overload behavior** — ``ShedError{queue_full, rate_limited,
  pool_pressure}`` maps to 503/429/503 with ``Retry-After`` derived
  from the admission token bucket (``AdmissionController.retry_after``);
  the ``X-Tenant`` header feeds the existing per-tenant rate limits. A
  client-supplied ``timeout_s`` maps onto ``Request.deadline_s``, so a
  blown deadline returns a partial-result terminal frame, never a hang.
- **Graceful drain** — SIGTERM/SIGINT (wired by
  ``python -m paddle_tpu_torch.tools.serve``) or
  :meth:`HTTPFrontDoor.begin_drain` stops admission (new requests get
  503 + ``Connection: close``), lets in-flight streams finish up to
  ``FLAGS_serve_drain_s``, cancels the stragglers with reason
  ``drained``, runs the watchdog emergency hooks + flight-recorder
  post-mortem, and reports ``serving_http_drain_seconds``.
- **Orchestration probes** — ``GET /healthz`` answers 200 while the
  process lives; ``GET /readyz`` answers 200 only while the step loop
  is healthy AND not draining (the load-balancer eviction signal).
- **Telemetry** — when observability is enabled the door also
  serves ``GET /metrics`` (Prometheus text) / ``/metrics.json`` (JSON
  snapshot) and the fleet federation views ``/fleet/metrics``,
  ``/fleet/replicas.json``, ``/fleet/placements.json`` — a scraper
  needs only the serving port; 503 while obs is off.
- **Recovery visibility** — a :class:`ResilientEngine` recovery during
  an active stream surfaces as an SSE ``: retrying`` comment frame on
  every live stream instead of a silent stall.

Threading model: three owners, no shared mutable engine state. The
asyncio loop thread owns sockets and per-connection coroutines; the
step-loop thread owns the engine (submissions and cancellations travel
to it through a thread-safe op queue; results travel back through
``call_soon_threadsafe``); the caller's thread only starts/stops/drains.
The engine is never touched off the step thread — the same single-owner
contract its pipelined state machine already requires.

    eng = LLMEngine(params, cfg, admission=AdmissionConfig(max_queue=64))
    front = HTTPFrontDoor(ResilientEngine(eng), port=8000)
    front.start()
    ...
    front.begin_drain(); front.wait_drained()

Stdlib-only: the module imports no torch, so the door runs wherever the
engine does; the card's work stays on the step-loop thread. Routes,
status codes, header names, flag names and the SSE bytes equal the
reference's, so one client reads either package's door.
"""
from __future__ import annotations

import asyncio
import collections
import json
import math
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import observability as _obs
from ..framework.flags import define_flag, get_flag
from ..observability import flight_recorder as _flight
from ..observability.catalog import instrument as _instrument
from .admission import AdmissionController, ShedError
from .resilient import ResilientEngine

__all__ = ["HTTPFrontDoor", "sse_token_frame", "sse_terminal_frame",
           "sse_retry_frame"]

define_flag("serve_client_stall_s", 10.0,
            "seconds a client may leave its SSE send queue above the "
            "high-water mark before the server cancels the request and "
            "aborts the connection (slow-reader protection)")
define_flag("serve_drain_s", 30.0,
            "graceful-drain budget: seconds in-flight streams may keep "
            "running after SIGTERM/begin_drain before they are cut "
            "with terminal reason 'drained'")
define_flag("serve_send_queue_hwm", 32,
            "per-connection send-queue high-water mark (queued frames); "
            "above it the slow-reader stall clock starts")

_M_HTTP_REQS = _instrument("serving_http_requests_total")
_M_ACTIVE_STREAMS = _instrument("serving_http_active_streams")
_M_DISCONNECTS = _instrument("serving_http_client_disconnects_total")
_M_SEND_QUEUE = _instrument("serving_http_send_queue_depth")
_M_DRAIN_SECONDS = _instrument("serving_http_drain_seconds")

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 408: "Request Timeout",
            413: "Payload Too Large", 429: "Too Many Requests",
            500: "Internal Server Error", 503: "Service Unavailable"}

# request bodies and header blocks buffer in memory before validation:
# bound them (every other per-connection resource here is bounded — the
# inputs must be too)
_MAX_BODY_BYTES = 1 << 20
_MAX_HEADER_LINES = 100


class _BodyTooLarge(Exception):
    def __init__(self, what: str, n: int, limit: int):
        super().__init__(f"request {what} of {n} exceeds the "
                         f"{limit} limit")


# ShedError.reason -> HTTP status (the typed-overload contract)
_SHED_STATUS = {"queue_full": 503, "rate_limited": 429,
                "pool_pressure": 503}


# ---------------------------------------------------------------------------
# SSE frame contract (canonical bytes — the parity tests compare these)
# ---------------------------------------------------------------------------
def _canon(obj) -> bytes:
    return json.dumps(obj, separators=(",", ":"), sort_keys=True).encode()


def sse_token_frame(token: int) -> bytes:
    """One generated token: ``data: {"token": N}\\n\\n``."""
    return b'data: {"token": ' + str(int(token)).encode() + b"}\n\n"


def sse_terminal_frame(request_id: int, reason: str,
                       tokens: List[int]) -> bytes:
    """The stream's last frame: finish reason + the FULL token list
    (tokens streamed before a preemption/recovery included), canonical
    JSON so a reference engine run reconstructs the exact bytes."""
    return b"data: " + _canon({"done": True, "reason": str(reason),
                               "request_id": int(request_id),
                               "tokens": [int(t) for t in tokens]}) \
        + b"\n\n"


def sse_retry_frame(recoveries: int) -> bytes:
    """SSE comment emitted when ResilientEngine recovers a crashed step
    while streams are live — comments are ignored by SSE parsers, so
    clients that don't care see nothing, and clients that do see the
    engine retrying instead of a silent stall."""
    return b": retrying engine-step recovery " \
        + str(int(recoveries)).encode() + b"\n\n"


# ---------------------------------------------------------------------------
# per-request stream state (created on the step thread at admission)
# ---------------------------------------------------------------------------
class _Stream:
    __slots__ = ("rid", "queue", "loop", "writer", "stall_t0",
                 "cancelled")

    def __init__(self, rid, queue, loop):
        self.rid = rid
        self.queue = queue          # asyncio.Queue, consumed on the loop
        self.loop = loop
        self.writer = None          # StreamWriter once the handler streams
        self.stall_t0 = None        # when qsize first crossed the HWM
        self.cancelled = False

    def post(self, item) -> None:
        """Thread-safe enqueue from the step thread (put_nowait must run
        on the loop thread — asyncio queues are not thread-safe)."""
        try:
            self.loop.call_soon_threadsafe(self.queue.put_nowait, item)
        except RuntimeError:
            pass                    # loop already closed (late shutdown)

    def abort(self) -> None:
        """Hard-close the connection from the loop thread: a stalled
        reader's writer coroutine is parked in ``drain()`` and can never
        send a terminal frame — aborting the transport unblocks it."""
        w = self.writer
        if w is not None:
            try:
                w.transport.abort()
            except Exception:
                pass


class HTTPFrontDoor:
    """Asyncio HTTP/1.1 + SSE server over a dedicated engine thread.

    ``engine``: an :class:`LLMEngine` or a :class:`ResilientEngine`
    (recoveries then surface as ``: retrying`` SSE comments).
    ``step_hook``: optional ``fn(raw_engine)`` invoked on the step
    thread after every engine step — the chaos harness's per-step
    ledger assertion point. ``port=0`` binds an ephemeral port
    (``.port`` holds the real one after :meth:`start`).
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 step_hook=None, idle_wait: float = 0.02):
        if isinstance(engine, ResilientEngine):
            self.resilient: Optional[ResilientEngine] = engine
            self.engine = engine.engine
        else:
            self.resilient = None
            self.engine = engine
        self.host = host
        self.port = int(port)
        self.step_hook = step_hook
        self.idle_wait = float(idle_wait)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server = None
        self._streams: Dict[int, _Stream] = {}   # step-thread-owned
        self._ops: collections.deque = collections.deque()
        self._wake = threading.Event()
        self._started = threading.Event()
        self._drained = threading.Event()
        self._drain_t0: Optional[float] = None
        self._drain_budget: Optional[float] = None
        self._drain_cut = False
        self._stopping = False
        self._healthy = True
        self._loop_thread: Optional[threading.Thread] = None
        self._step_thread: Optional[threading.Thread] = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> Tuple[str, int]:
        """Bind the server and start the loop + step threads; returns
        ``(host, port)`` once the socket is listening."""
        self._loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(
            target=self._loop_main, name="serving-http-loop", daemon=True)
        self._loop_thread.start()
        self._started.wait(10)
        if not self._started.is_set():
            raise RuntimeError("HTTP front door failed to start")
        self._step_thread = threading.Thread(
            target=self._step_loop, name="serving-http-step", daemon=True)
        self._step_thread.start()
        return self.host, self.port

    def _loop_main(self) -> None:
        asyncio.set_event_loop(self._loop)

        async def boot():
            self._server = await asyncio.start_server(
                self._handle, self.host, self.port)
            self.port = self._server.sockets[0].getsockname()[1]

        try:
            self._loop.run_until_complete(boot())
        finally:
            self._started.set()
        try:
            self._loop.run_forever()
        finally:
            try:
                if self._server is not None:
                    self._server.close()
                self._loop.run_until_complete(asyncio.sleep(0))
            except Exception:
                pass
            self._loop.close()

    def begin_drain(self, drain_s: Optional[float] = None) -> None:
        """Start graceful drain (idempotent, any thread): admission
        stops, ``/readyz`` flips to 503, in-flight streams run up to
        the budget (``FLAGS_serve_drain_s`` unless overridden), then
        stragglers are cancelled with terminal reason ``drained``."""
        if self._drain_t0 is not None:
            return
        self._drain_budget = (float(get_flag("serve_drain_s"))
                              if drain_s is None else float(drain_s))
        self._drain_t0 = time.monotonic()
        _flight.record("serving_drain_begin",
                       live_streams=len(self._streams),
                       budget_s=self._drain_budget)
        self._wake.set()

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        return self._drained.wait(timeout)

    def stop(self, drain_s: float = 0.0,
             timeout: float = 30.0) -> None:
        """Drain (default: immediately — tests and Ctrl-C-twice) and
        tear the threads down."""
        self.begin_drain(drain_s=drain_s)
        self._drained.wait(timeout)
        time.sleep(0.25)          # let final terminal frames flush
        self._stopping = True
        self._wake.set()
        if self._loop is not None:
            try:
                self._loop.call_soon_threadsafe(self._loop.stop)
            except RuntimeError:
                pass
        if self._step_thread is not None:
            self._step_thread.join(timeout)
        if self._loop_thread is not None:
            self._loop_thread.join(timeout)

    @property
    def draining(self) -> bool:
        return self._drain_t0 is not None

    @property
    def ready(self) -> bool:
        """The ``/readyz`` condition: step loop alive and healthy, not
        draining."""
        return (self._healthy and not self.draining
                and self._step_thread is not None
                and self._step_thread.is_alive())

    @property
    def active_streams(self) -> int:
        return len(self._streams)

    # -- step-loop thread (the engine's single owner) ---------------------
    def _stepper_step(self):
        return (self.resilient.step() if self.resilient is not None
                else self.engine.step())

    def _step_loop(self) -> None:
        eng = self.engine
        try:
            while not self._stopping:
                self._run_ops()
                if self.draining and not self._drain_cut and \
                        time.monotonic() - self._drain_t0 \
                        > self._drain_budget:
                    # budget blown: cut every straggler — terminal
                    # reason "drained", applied by the next step
                    self._drain_cut = True
                    for rid in list(self._streams):
                        eng.cancel_request(rid, reason="drained")
                if eng.has_work():
                    rec0 = (self.resilient.recoveries
                            if self.resilient is not None else 0)
                    emitted = self._stepper_step()
                    if self.resilient is not None \
                            and self.resilient.recoveries > rec0:
                        # recovery mid-stream: every live client sees a
                        # retrying comment, never a silent stall
                        frame_n = self.resilient.recoveries
                        for st in self._streams.values():
                            st.post(("retry", frame_n))
                    self._route(emitted)
                    self._notify_terminals()
                    self._sweep_stalls()
                    if self.step_hook is not None:
                        self.step_hook(eng)
                else:
                    if eng._inflight is not None:   # defensive, as run()
                        self._route(eng._process_inflight())
                    self._notify_terminals()
                    if self.draining and not self._streams:
                        break
                    self._wake.wait(self.idle_wait)
                    self._wake.clear()
        except Exception as e:                       # pragma: no cover
            # an unrecoverable engine error must not strand clients in
            # a silent hang: fail every live stream and go unready
            self._healthy = False
            _flight.record("serving_http_step_loop_died",
                           error=f"{type(e).__name__}: {e}"[:160])
            for rid, st in list(self._streams.items()):
                st.post(("done", "error",
                         list(eng.results.get(rid, []))))
                self._streams.pop(rid, None)
        finally:
            self._finish_drain()

    def _fail_pending_ops(self) -> None:
        """Resolve any submit op still queued when the step loop is gone
        (the drain-complete break can race a handler's append): its
        client must get the draining 503, not an eternal ``await fut``.
        Safe from either thread — deque pops are atomic and the futures
        resolve on the loop thread, first setter wins."""
        while self._ops:
            try:
                op = self._ops.popleft()
            except IndexError:
                break
            if op[0] != "submit":
                continue
            fut = op[3]

            def _fail(f=fut):
                if not f.done():
                    f.set_exception(ShedError("draining"))
            try:
                self._loop.call_soon_threadsafe(_fail)
            except RuntimeError:
                pass

    def _finish_drain(self) -> None:
        if self._drained.is_set():
            return
        self._fail_pending_ops()
        if self._drain_t0 is not None:
            elapsed = time.monotonic() - self._drain_t0
            _M_DRAIN_SECONDS.observe(elapsed)
            _flight.record("serving_drain_done",
                           elapsed_s=round(elapsed, 3))
            # "checkpoint" analog of the train loop's SIGTERM path: run
            # the registered watchdog emergency hooks (a serving process
            # with a checkpointing hook flushes it here), then the
            # flight-recorder post-mortem when FLAGS_obs_postmortem_dir
            # is set
            from ..distributed.watchdog import run_emergency_hooks
            run_emergency_hooks("serving-drain", elapsed)
            _flight.maybe_dump("sigterm")
        if _obs.enabled():
            _M_ACTIVE_STREAMS.set(0)
        self._drained.set()
        # close the append/flag race: a handler that appended its op
        # before the set() above either got popped by the first
        # _fail_pending_ops or gets popped here; one that appends after
        # the set() sees _drained in _generate and fails its own op
        self._fail_pending_ops()

    def _run_ops(self) -> None:
        """Apply queued submissions/cancellations from the loop thread
        — the only path by which connections touch the engine."""
        while self._ops:
            op = self._ops.popleft()
            if op[0] == "submit":
                _kind, kw, queue, fut = op
                self._op_submit(kw, queue, fut)
            elif op[0] == "cancel":
                _kind, rid, cause = op
                st = self._streams.get(rid)
                if st is not None and not st.cancelled:
                    st.cancelled = True
                    self.engine.cancel_request(
                        rid, reason="client_disconnected")
                    _M_DISCONNECTS.inc()
                    _flight.record("serving_http_client_disconnect",
                                   req_id=rid, cause=cause)
                self._wake.set()

    def _op_submit(self, kw: Dict, queue, fut) -> None:
        loop = self._loop
        try:
            if self.draining:
                raise ShedError("draining")
            rid = self.engine.add_request(kw.pop("prompt"), **kw)
        except BaseException as e:
            err = e

            def _fail():
                if not fut.cancelled():
                    fut.set_exception(err)
            loop.call_soon_threadsafe(_fail)
            return
        st = _Stream(rid, queue, loop)
        self._streams[rid] = st
        if _obs.enabled():
            _M_ACTIVE_STREAMS.set(len(self._streams))

        def _ok():
            if not fut.cancelled():
                fut.set_result((rid, st))
        loop.call_soon_threadsafe(_ok)

    def _route(self, emitted) -> None:
        """Fan one step's (rid, token) pairs out to their streams — one
        cross-thread post per request per step, not per token."""
        if not emitted:
            return
        per: Dict[int, List[int]] = {}
        for rid, tok in emitted:
            per.setdefault(rid, []).append(int(tok))
        for rid, toks in per.items():
            st = self._streams.get(rid)
            if st is not None:
                st.post(("toks", toks))

    def _notify_terminals(self) -> None:
        """Close out every owned stream whose request reached a terminal
        reason this step (finished / deadline_exceeded /
        client_disconnected / drained)."""
        if not self._streams:
            return
        reasons = self.engine.finish_reasons
        done = [rid for rid in self._streams if rid in reasons]
        for rid in done:
            st = self._streams.pop(rid)
            st.post(("done", reasons[rid],
                     list(self.engine.results.get(rid, []))))
        if done and _obs.enabled():
            _M_ACTIVE_STREAMS.set(len(self._streams))

    def _sweep_stalls(self) -> None:
        """Slow-reader protection: a stream whose send queue sits above
        the high-water mark for longer than FLAGS_serve_client_stall_s
        is cancelled server-side and its connection aborted. qsize() is
        a plain deque length — safe to read cross-thread."""
        if not self._streams:
            if _obs.enabled():
                _M_SEND_QUEUE.set(0)
            return
        hwm = int(get_flag("serve_send_queue_hwm"))
        stall_s = float(get_flag("serve_client_stall_s"))
        now = time.monotonic()
        depth_max = 0
        for rid, st in list(self._streams.items()):
            depth = st.queue.qsize()
            depth_max = max(depth_max, depth)
            if depth <= hwm:
                st.stall_t0 = None
                continue
            if st.stall_t0 is None:
                st.stall_t0 = now
            elif now - st.stall_t0 > stall_s and not st.cancelled:
                st.cancelled = True
                self.engine.cancel_request(
                    rid, reason="client_disconnected")
                _M_DISCONNECTS.inc()
                _flight.record("serving_http_client_stalled",
                               req_id=rid, queued_frames=depth,
                               stalled_s=round(now - st.stall_t0, 3))
                # the writer coroutine is parked in drain() and can
                # never deliver a terminal frame — abort the transport
                if self._loop is not None:
                    try:
                        self._loop.call_soon_threadsafe(st.abort)
                    except RuntimeError:
                        pass
        if _obs.enabled():
            _M_SEND_QUEUE.set(depth_max)

    # -- asyncio loop thread (sockets only, never the engine) -------------
    async def _handle(self, reader, writer) -> None:
        t0 = time.perf_counter()
        code = 500
        path = "?"
        method = "?"
        try:
            # modest write buffer: drain() must apply backpressure per
            # frame, not after the kernel swallowed kilobytes of them
            writer.transport.set_write_buffer_limits(high=4096, low=1024)
            req = await asyncio.wait_for(self._read_request(reader), 30)
            if req is None:
                # connect-then-close (a TCP health probe) or a garbage
                # request line: nothing was answered, so nothing counts
                # — a load balancer probing every few seconds must not
                # read as a climbing 500 rate
                code = None
                return
            method, path, headers, body = req
            code = await self._dispatch(method, path, headers, body,
                                        reader, writer)
        except _BodyTooLarge as e:
            try:
                self._respond(writer, 413, {"error": str(e)})
            except Exception:
                pass
            code = 413
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.TimeoutError, BrokenPipeError):
            code = 408
        except Exception as e:
            try:
                self._respond(writer, 500,
                              {"error": f"{type(e).__name__}: {e}"})
                code = 500
            except Exception:
                pass
        finally:
            if code is not None:
                _M_HTTP_REQS.inc(code=str(code))
                if _obs.enabled():
                    _obs.get_tracer().record(
                        "serving.http_request", t0, time.perf_counter(),
                        {"method": method, "path": path, "code": code},
                        depth=0)
            try:
                writer.close()
            except Exception:
                pass

    async def _read_request(self, reader):
        line = await reader.readline()
        if not line:
            return None
        parts = line.decode("latin1").split()
        if len(parts) < 2:
            return None
        method, path = parts[0].upper(), parts[1]
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            if len(headers) >= _MAX_HEADER_LINES:
                # a client streaming endless header lines would grow
                # this dict for the whole request timeout otherwise
                raise _BodyTooLarge("header lines", len(headers) + 1,
                                    _MAX_HEADER_LINES)
            k, _, v = h.decode("latin1").partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length") or 0)
        if n > _MAX_BODY_BYTES:
            # before buffering a single body byte
            raise _BodyTooLarge("body bytes", n, _MAX_BODY_BYTES)
        body = await reader.readexactly(n) if n else b""
        return method, path, headers, body

    def _respond(self, writer, code: int, obj, extra=()) -> None:
        body = _canon(obj) + b"\n"
        head = (f"HTTP/1.1 {code} {_REASONS.get(code, 'Unknown')}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n"
                "Connection: close\r\n")
        for k, v in extra:
            head += f"{k}: {v}\r\n"
        writer.write(head.encode("latin1") + b"\r\n" + body)

    def _respond_text(self, writer, code: int, text: str,
                      ctype: str = "text/plain; version=0.0.4; "
                                   "charset=utf-8") -> None:
        body = text.encode()
        head = (f"HTTP/1.1 {code} {_REASONS.get(code, 'Unknown')}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n"
                "Connection: close\r\n")
        writer.write(head.encode("latin1") + b"\r\n" + body)

    def _telemetry(self, method, path, writer) -> Optional[int]:
        """Serve the observability surface off the front door itself:
        /metrics + /metrics.json (this process's registry) and
        the /fleet/* federation views — a scraper needs only the door's
        port, no separate obs server. None when ``path`` is not a
        telemetry route; all are read-only GETs."""
        if path not in ("/metrics", "/metrics.json", "/fleet/metrics",
                        "/fleet/replicas.json", "/fleet/placements.json",
                        "/alerts.json"):
            return None
        if method != "GET":
            self._respond(writer, 405, {"error": "GET only"})
            return 405
        import paddle_tpu_torch.observability as _obs

        if not _obs.enabled():
            self._respond(writer, 503,
                          {"error": "observability disabled "
                                    "(FLAGS_obs_enabled)"})
            return 503
        from paddle_tpu_torch.observability import fleet as _fleet
        from paddle_tpu_torch.observability.exposition import (
            render_prometheus, snapshot)

        if path == "/metrics":
            self._respond_text(writer, 200, render_prometheus())
        elif path == "/metrics.json":
            self._respond(writer, 200, snapshot())
        elif path == "/fleet/metrics":
            self._respond_text(writer, 200, _fleet.fleet_metrics_text())
        elif path == "/fleet/replicas.json":
            self._respond(writer, 200, _fleet.replicas_payload())
        elif path == "/alerts.json":
            from paddle_tpu_torch.observability import timeseries as _ts

            self._respond(writer, 200, _ts.alerts_payload())
        else:
            self._respond(writer, 200, _fleet.placements_payload())
        return 200

    async def _dispatch(self, method, path, headers, body, reader,
                        writer) -> int:
        path = path.split("?", 1)[0]
        if path == "/healthz":
            if method != "GET":
                self._respond(writer, 405, {"error": "GET only"})
                return 405
            self._respond(writer, 200,
                          {"ok": True, "draining": self.draining})
            return 200
        if path == "/readyz":
            if method != "GET":
                self._respond(writer, 405, {"error": "GET only"})
                return 405
            code = 200 if self.ready else 503
            self._respond(writer, code,
                          {"ready": self.ready,
                           "draining": self.draining})
            return code
        code = self._telemetry(method, path, writer)
        if code is not None:
            return code
        if path != "/v1/generate":
            self._respond(writer, 404, {"error": f"no route {path}"})
            return 404
        if method != "POST":
            self._respond(writer, 405, {"error": "POST only"})
            return 405
        return await self._generate(headers, body, reader, writer)

    # -- /v1/generate -----------------------------------------------------
    def _parse_generate(self, headers, body) -> Tuple[Dict, bool]:
        try:
            doc = json.loads(body.decode() or "{}")
        except (ValueError, UnicodeDecodeError) as e:
            raise ValueError(f"bad JSON body: {e}")
        if not isinstance(doc, dict):
            raise ValueError("body must be a JSON object")
        prompt = doc.get("prompt")
        if not isinstance(prompt, list) or not prompt \
                or not all(isinstance(t, int) for t in prompt):
            raise ValueError(
                "'prompt' must be a non-empty list of token ids (the "
                "engine is tokenizer-free; tokenize client-side)")
        kw: Dict = {"prompt": [int(t) for t in prompt]}
        for key, typ in (("max_new_tokens", int), ("temperature", float),
                         ("top_k", int), ("top_p", float),
                         ("eos_token_id", int)):
            if doc.get(key) is not None:
                try:
                    kw[key] = typ(doc[key])
                except (TypeError, ValueError):
                    raise ValueError(f"'{key}' must be a {typ.__name__}")
        # the client's latency budget becomes the engine's deadline:
        # expiry delivers a partial-result terminal frame, never a hang
        if doc.get("timeout_s") is not None:
            try:
                kw["deadline_s"] = float(doc["timeout_s"])
            except (TypeError, ValueError):
                raise ValueError("'timeout_s' must be a number")
        tenant = headers.get("x-tenant")
        if tenant:
            kw["tenant"] = str(tenant)
        stream = doc.get("stream", True)
        if not isinstance(stream, bool):
            raise ValueError("'stream' must be a boolean")
        return kw, stream

    def _shed_response(self, writer, exc: ShedError, kw: Dict) -> int:
        code = _SHED_STATUS.get(exc.reason, 503)
        retry_after = 1.0
        adm = self.engine.admission
        if exc.reason == "rate_limited" \
                and isinstance(adm, AdmissionController):
            cost = len(kw.get("prompt") or ()) \
                + int(kw.get("max_new_tokens", 64))
            retry_after = max(
                1.0, adm.retry_after(kw.get("tenant", "default"), cost))
        self._respond(
            writer, code,
            {"error": str(exc), "reason": exc.reason,
             "request_id": exc.req_id},
            extra=[("Retry-After", str(int(math.ceil(retry_after))))])
        return code

    async def _generate(self, headers, body, reader, writer) -> int:
        if self.draining:
            # stopped admission: orchestrators see Connection: close +
            # 503 and take the replica out of rotation
            self._respond(writer, 503,
                          {"error": "draining", "reason": "draining"})
            return 503
        try:
            kw, stream = self._parse_generate(headers, body)
        except ValueError as e:
            self._respond(writer, 400, {"error": str(e)})
            return 400
        fut = self._loop.create_future()
        queue: asyncio.Queue = asyncio.Queue()
        self._ops.append(("submit", dict(kw), queue, fut))
        self._wake.set()
        if self._drained.is_set():
            # the step loop may already have taken its final _run_ops
            # pass — resolve the orphan here instead of awaiting forever
            self._fail_pending_ops()
        try:
            rid, st = await fut
        except ShedError as e:
            if e.reason == "draining":
                self._respond(writer, 503,
                              {"error": "draining",
                               "reason": "draining"})
                return 503
            return self._shed_response(writer, e, kw)
        except ValueError as e:
            self._respond(writer, 400, {"error": str(e)})
            return 400
        if stream:
            return await self._stream_sse(rid, st, reader, writer)
        return await self._respond_json(rid, st, reader, writer)

    def _request_cancel(self, rid: int, cause: str) -> None:
        self._ops.append(("cancel", rid, cause))
        self._wake.set()

    async def _drain_bounded(self, writer) -> None:
        """``drain()`` with a hard deadline. The stall sweep only covers
        streams the front door still owns — a client that stops reading
        right as its request reaches a terminal reason leaves the sweep's
        sight (``_notify_terminals`` pops it), so the writer itself must
        never park in ``drain()`` forever holding the socket, the
        coroutine and the queued frames. A blown deadline aborts the
        transport and surfaces as the disconnect path."""
        try:
            await asyncio.wait_for(
                writer.drain(),
                max(1.0, float(get_flag("serve_client_stall_s"))))
        except asyncio.TimeoutError:
            try:
                writer.transport.abort()
            except Exception:
                pass
            raise ConnectionResetError(
                "client write stalled past FLAGS_serve_client_stall_s")

    async def _watch_eof(self, reader) -> None:
        """Resolve when the client's half of the socket closes — the
        mid-stream disconnect signal (clients never send bytes after
        the request, so any read completing means EOF or junk)."""
        while True:
            try:
                data = await reader.read(65536)
            except (ConnectionError, asyncio.CancelledError):
                return
            if not data:
                return

    async def _stream_sse(self, rid, st: _Stream, reader,
                          writer) -> int:
        st.writer = writer
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-store\r\n"
                     b"Connection: close\r\n\r\n")
        eof_task = asyncio.ensure_future(self._watch_eof(reader))
        get_task = None
        try:
            await self._drain_bounded(writer)
            while True:
                get_task = asyncio.ensure_future(st.queue.get())
                done, _pending = await asyncio.wait(
                    {get_task, eof_task},
                    return_when=asyncio.FIRST_COMPLETED)
                if eof_task in done:
                    # client hung up mid-stream (EOF wins even over a
                    # ready frame — the socket is gone): cancel
                    # server-side so the slot + KV blocks free at the
                    # next engine step
                    get_task.cancel()
                    self._request_cancel(rid, "eof")
                    return 200
                item = get_task.result()
                if item[0] == "toks":
                    for tok in item[1]:
                        writer.write(sse_token_frame(tok))
                    await self._drain_bounded(writer)
                elif item[0] == "retry":
                    writer.write(sse_retry_frame(item[1]))
                    await self._drain_bounded(writer)
                elif item[0] == "done":
                    writer.write(sse_terminal_frame(rid, item[1],
                                                    item[2]))
                    await self._drain_bounded(writer)
                    return 200
        except (ConnectionError, BrokenPipeError,
                asyncio.CancelledError):
            self._request_cancel(rid, "write_failed")
            return 200
        finally:
            eof_task.cancel()
            if get_task is not None and not get_task.done():
                get_task.cancel()

    async def _respond_json(self, rid, st: _Stream, reader,
                            writer) -> int:
        """Non-streaming mode: consume the stream queue privately and
        answer with one JSON body at the terminal."""
        eof_task = asyncio.ensure_future(self._watch_eof(reader))
        try:
            while True:
                get_task = asyncio.ensure_future(st.queue.get())
                done, _pending = await asyncio.wait(
                    {get_task, eof_task},
                    return_when=asyncio.FIRST_COMPLETED)
                if eof_task in done:
                    get_task.cancel()
                    self._request_cancel(rid, "eof")
                    return 408
                item = get_task.result()
                if item[0] == "done":
                    self._respond(writer, 200,
                                  {"request_id": int(rid),
                                   "reason": item[1],
                                   "tokens": item[2]})
                    await self._drain_bounded(writer)
                    return 200
        except (ConnectionError, BrokenPipeError,
                asyncio.CancelledError):
            self._request_cancel(rid, "write_failed")
            return 408
        finally:
            eof_task.cancel()

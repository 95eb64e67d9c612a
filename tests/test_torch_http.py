"""The port's HTTP/SSE front door (paddle_tpu_torch.serving.http) and its
serve CLI held to the JAX package's on the CPU, on the same tiny f32
model, through raw stdlib sockets.

- the SSE body of every request equals the JAX front door's body byte
  for byte (greedy f32, and f32 with int8 K/V), and the frames a direct
  engine run gives; ``"stream": false`` returns the same tokens;
- a mid-stream disconnect cancels server-side (``client_disconnected``,
  no backed blocks); a slow reader is cancelled by the stall sweep
  (driven white-box with an injected clock);
- ``ShedError`` maps to 503 / 429 with ``Retry-After`` from
  ``AdmissionController.retry_after``; bad bodies are 400 and oversized
  ones 413, with the reference's codes; ``timeout_s`` ends in a partial
  ``deadline_exceeded`` terminal frame;
- drain flips ``/readyz`` to 503, refuses new posts with 503 +
  ``Connection: close``, lets live streams finish and sets
  ``serving_http_drain_seconds``; a drain budget cuts stragglers with
  ``drained``; a ``ResilientEngine`` recovery shows as a ``: retrying``
  frame with the stream exactly-once;
- the telemetry routes answer 503 while observability is off and serve
  the registry and the fleet views when it is on;
- ``python -m paddle_tpu_torch.tools.serve --device cpu`` prints
  ``serving on``, answers, and drains to ``drained; bye`` on SIGINT."""
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

import paddle_tpu_torch.observability as tobs
from conftest import assert_blocks_balanced
from paddle_tpu.serving import HTTPFrontDoor as JaxFrontDoor
from paddle_tpu.serving.http import sse_terminal_frame as jax_terminal
from paddle_tpu.serving.http import sse_token_frame as jax_token
from paddle_tpu_torch.distributed.resilience import FaultInjector
from paddle_tpu_torch.framework.flags import get_flag, set_flags
from paddle_tpu_torch.serving import (AdmissionConfig,
                                      AdmissionController, HTTPFrontDoor,
                                      ResilientEngine)
from paddle_tpu_torch.serving import http as thttp
from paddle_tpu_torch.serving.http import (_Stream, sse_retry_frame,
                                           sse_terminal_frame,
                                           sse_token_frame)
from test_torch_router import jengine, make_model, prompts, tengine, wait_for
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model():
    return make_model()


@pytest.fixture
def obs_on():
    tobs.get_registry().reset()
    tobs.enable()
    try:
        yield tobs.get_registry()
    finally:
        tobs.disable()
        tobs.get_registry().reset()


def _post(host, port, doc, headers=(), timeout=120, raw_body=None):
    """Open a raw client connection and send one POST /v1/generate."""
    s = socket.create_connection((host, port), timeout=timeout)
    body = raw_body if raw_body is not None else json.dumps(doc).encode()
    head = (f"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
            f"Content-Length: {len(body)}\r\n")
    for k, v in headers:
        head += f"{k}: {v}\r\n"
    s.sendall(head.encode() + b"\r\n" + body)
    return s


def _recv_all(s):
    data = b""
    while True:
        c = s.recv(65536)
        if not c:
            break
        data += c
    s.close()
    return data


def _get(host, port, path):
    s = socket.create_connection((host, port), timeout=60)
    s.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    return _recv_all(s)


def _status(raw: bytes) -> int:
    return int(raw.split(b" ", 2)[1])


def _split(raw: bytes):
    head, _, body = raw.partition(b"\r\n\r\n")
    return head, body


def _read_frames(s, n):
    """Read until ``n`` SSE ``data:`` frames arrived."""
    buf = b""
    while buf.count(b"data:") < n or not buf.endswith(b"\n\n"):
        c = s.recv(1)
        if not c:
            break
        buf += c
    return buf


def _frames(body: bytes):
    return [json.loads(c.split(b"\n", 1)[0])
            for c in body.split(b"data: ")[1:]]


# ---------------------------------------------------------------------------
# SSE bytes equal the JAX front door's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv", [None, "int8"])
def test_sse_bytes_equal_jax_front_door(model, kv):
    jcfg, jp, tcfg, tp = model
    ps = prompts(0, 3)
    ref = tengine(tp, tcfg, kv_dtype=kv)
    ids = [ref.add_request(list(p), max_new_tokens=8) for p in ps]
    ref_out = ref.run()
    bodies = {}
    for name, door, eng in (
            ("torch", HTTPFrontDoor, tengine(tp, tcfg, kv_dtype=kv)),
            ("jax", JaxFrontDoor, jengine(jp, jcfg, kv_dtype=kv))):
        front = door(eng)
        host, port = front.start()
        try:
            bodies[name] = [_split(_recv_all(_post(
                host, port, {"prompt": p, "max_new_tokens": 8})))[1]
                for p in ps]
            raw = _recv_all(_post(host, port, {
                "prompt": ps[0], "max_new_tokens": 8, "stream": False}))
            doc = json.loads(_split(raw)[1])
            assert doc["tokens"] == ref_out[ids[0]]
            assert doc["reason"] == "finished"
        finally:
            front.stop()
        assert set(eng.finish_reasons.values()) == {"finished"}
    assert bodies["torch"] == bodies["jax"]
    for rid, body in zip(ids, bodies["torch"]):
        toks = ref_out[rid]
        assert body == b"".join(sse_token_frame(t) for t in toks) \
            + sse_terminal_frame(rid, "finished", toks)
    # the frame contract itself is the reference's
    assert sse_token_frame(7) == jax_token(7)
    assert sse_terminal_frame(3, "drained", [1, 2]) \
        == jax_terminal(3, "drained", [1, 2])


# ---------------------------------------------------------------------------
# disconnects and slow readers
# ---------------------------------------------------------------------------
def test_disconnect_cancels_and_frees_blocks(model, obs_on):
    _, _, tcfg, tp = model
    eng = tengine(tp, tcfg)
    # 20 ms a step: the stream outlasts the close by a wide margin
    eng.injector = FaultInjector([("slow_step", s) for s in range(1, 99)])
    front = HTTPFrontDoor(eng)
    host, port = front.start()
    try:
        s = _post(host, port, {"prompt": prompts(1, 1)[0],
                               "max_new_tokens": 50})
        assert b"data:" in _read_frames(s, 2)
        s.close()                                  # mid-stream
        wait_for(lambda: 0 in eng.finish_reasons)
        assert eng.finish_reasons[0] == "client_disconnected"
        assert eng.block_accounting()["backed"] == 0
        assert_blocks_balanced(eng)
        assert len(eng.results[0]) >= 2
        assert obs_on.counter("serving_http_client_disconnects_total") \
            .labels().value >= 1
        doc = tobs.get_request_tracer().get(0)
        assert doc["summary"]["reason"] == "client_disconnected"
    finally:
        front.stop()


class _Clock:
    """The ``time`` module with a ``monotonic`` that reads ``now``."""

    def __init__(self):
        self.now = 100.0

    def monotonic(self):
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def test_slow_reader_stall_sweep_cancels(model, obs_on, monkeypatch):
    _, _, tcfg, tp = model
    eng = tengine(tp, tcfg)
    front = HTTPFrontDoor(eng)                 # never started: no threads
    rid = eng.add_request(prompts(2, 1)[0], max_new_tokens=8)
    eng.step()

    class _StuckQueue:
        def qsize(self):
            return 99                          # frames nobody drains

    st = _Stream(rid, _StuckQueue(), None)
    front._streams[rid] = st
    clock = _Clock()
    monkeypatch.setattr(thttp, "time", clock)
    saved = {k: get_flag(k) for k in ("serve_client_stall_s",
                                      "serve_send_queue_hwm")}
    set_flags({"serve_client_stall_s": 1.0, "serve_send_queue_hwm": 4})
    try:
        front._sweep_stalls()                  # arms the stall clock
        assert st.stall_t0 == 100.0 and not st.cancelled
        clock.now += 1.0
        front._sweep_stalls()                  # at the budget: not past
        assert not st.cancelled and rid not in eng._cancels
        clock.now += 0.5
        front._sweep_stalls()                  # past it: cancels
        assert st.cancelled
        while eng.has_work():
            eng.step()
        assert eng.finish_reasons[rid] == "client_disconnected"
        assert eng.block_accounting()["backed"] == 0
        assert_blocks_balanced(eng)
        assert obs_on.counter("serving_http_client_disconnects_total") \
            .labels().value == 1
        assert obs_on.gauge("serving_http_send_queue_depth").labels() \
            .value == 99
    finally:
        set_flags(saved)


# ---------------------------------------------------------------------------
# overload mapping and request validation
# ---------------------------------------------------------------------------
def test_queue_full_maps_503_with_retry_after(model):
    _, _, tcfg, tp = model
    ps = prompts(3, 3)
    eng = tengine(tp, tcfg, max_slots=1,
                  admission=AdmissionConfig(max_queue=1))
    # 20 ms a step: the first stream holds the slot while the others come
    eng.injector = FaultInjector([("slow_step", s) for s in range(1, 99)])
    front = HTTPFrontDoor(eng)
    host, port = front.start()
    try:
        s1 = _post(host, port, {"prompt": ps[0], "max_new_tokens": 50})
        _read_frames(s1, 1)                    # admitted and decoding
        done2 = {}

        def queued_client():
            raw = _recv_all(_post(host, port, {
                "prompt": ps[1], "max_new_tokens": 4, "stream": False}))
            done2["status"] = _status(raw)

        t = threading.Thread(target=queued_client)
        t.start()
        try:
            wait_for(lambda: len(eng.queue) >= 1)
            raw = _recv_all(_post(host, port, {
                "prompt": ps[2], "max_new_tokens": 4}))
            head, body = _split(raw)
            assert _status(raw) == 503
            assert b"Retry-After:" in head
            assert json.loads(body)["reason"] == "queue_full"
            _recv_all(s1)
        finally:
            t.join(120)
        assert done2["status"] == 200
    finally:
        front.stop()
    assert "shed" in eng.finish_reasons.values()


def test_rate_limited_maps_429_with_bucket_retry_after(model):
    _, _, tcfg, tp = model
    ps = prompts(4, 2)
    # a bucket on a clock that stands still: burst 30 at a cost of
    # 6 + 20 = 26 a request leaves 4 tokens, a deficit of 22 at 2/s
    adm = AdmissionController(
        AdmissionConfig(max_queue=16, rate_tokens_per_s=2.0,
                        burst_tokens=30.0), now_fn=lambda: 50.0)
    eng = tengine(tp, tcfg, admission=adm)
    front = HTTPFrontDoor(eng)
    host, port = front.start()
    try:
        raw = _recv_all(_post(host, port, {
            "prompt": ps[0], "max_new_tokens": 20, "stream": False}))
        assert _status(raw) == 200
        raw = _recv_all(_post(host, port, {
            "prompt": ps[0], "max_new_tokens": 20}))
        head, body = _split(raw)
        assert _status(raw) == 429
        assert json.loads(body)["reason"] == "rate_limited"
        assert adm.retry_after("default", 26.0) == 11.0
        assert re.search(rb"Retry-After: (\d+)", head).group(1) == b"11"
        raw = _recv_all(_post(host, port, {
            "prompt": ps[1], "max_new_tokens": 20, "stream": False},
            headers=[("X-Tenant", "other")]))
        assert _status(raw) == 200          # another tenant's bucket
    finally:
        front.stop()


def test_bad_and_oversized_requests(model):
    jcfg, jp, tcfg, tp = model
    docs = ({"max_new_tokens": 4}, {"prompt": "text"},
            {"prompt": [1, 2], "max_new_tokens": "x"},
            {"prompt": [1, 2], "max_new_tokens": 400}, [1, 2])
    codes = {}
    for name, door, eng in (("torch", HTTPFrontDoor, tengine(tp, tcfg)),
                            ("jax", JaxFrontDoor, jengine(jp, jcfg))):
        front = door(eng)
        host, port = front.start()
        try:
            got = [_status(_recv_all(_post(host, port, d))) for d in docs]
            got.append(_status(_recv_all(_post(host, port, None,
                                               raw_body=b"{not json"))))
            # past the body bound: refused before a byte is read
            s = socket.create_connection((host, port), timeout=60)
            s.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Length: %d\r\n\r\n"
                      % (thttp._MAX_BODY_BYTES + 1))
            got.append(_status(_recv_all(s)))
            got.append(_status(_get(host, port, "/v1/generate")))
            got.append(_status(_get(host, port, "/nope")))
            raw = _get(host, port, "/healthz")
            got.append((_status(raw), json.loads(_split(raw)[1])))
            codes[name] = got
        finally:
            front.stop()
        assert eng.finish_reasons == {}
    assert codes["torch"] == codes["jax"]
    assert codes["torch"][:6] == [400] * 6
    assert codes["torch"][6:] == [413, 405, 404,
                                  (200, {"ok": True, "draining": False})]


# ---------------------------------------------------------------------------
# deadlines, drain, recovery
# ---------------------------------------------------------------------------
def test_timeout_returns_partial_result_frame(model):
    _, _, tcfg, tp = model
    eng = tengine(tp, tcfg, max_slots=1)
    # every step is slowed 20 ms: the 0.6 s budget cannot cover 50 tokens,
    # and the first token is out long before it
    eng.injector = FaultInjector([("slow_step", s) for s in range(1, 99)])
    front = HTTPFrontDoor(eng)
    host, port = front.start()
    try:
        raw = _recv_all(_post(host, port, {
            "prompt": prompts(5, 1)[0], "max_new_tokens": 50,
            "timeout_s": 0.6}))
        frames = _frames(_split(raw)[1])
        terminal = frames[-1]
        assert terminal["done"]
        assert terminal["reason"] == "deadline_exceeded"
        streamed = [f["token"] for f in frames if "token" in f]
        assert streamed == terminal["tokens"]       # exactly-once
        assert 0 < len(streamed) < 50
    finally:
        front.stop()
    assert_blocks_balanced(eng)


def test_drain_finishes_streams_and_flips_readyz(model, obs_on):
    _, _, tcfg, tp = model
    ps = prompts(6, 2)
    eng = tengine(tp, tcfg)
    front = HTTPFrontDoor(eng)
    host, port = front.start()
    try:
        assert _status(_get(host, port, "/readyz")) == 200
        s = _post(host, port, {"prompt": ps[0], "max_new_tokens": 40})
        _read_frames(s, 1)
        front.begin_drain(drain_s=60)
        assert _status(_get(host, port, "/readyz")) == 503
        assert _status(_get(host, port, "/healthz")) == 200
        raw = _recv_all(_post(host, port, {"prompt": ps[1],
                                           "max_new_tokens": 2}))
        head, body = _split(raw)
        assert _status(raw) == 503
        assert b"Connection: close" in head
        assert json.loads(body)["reason"] == "draining"
        terminal = _frames(_recv_all(s))[-1]       # the rest of the body
        assert terminal["reason"] == "finished"
        assert len(terminal["tokens"]) == 40
        assert front.wait_drained(60)
        assert front.active_streams == 0
        assert sum(obs_on.histogram("serving_http_drain_seconds")
                   .labels().counts) == 1
    finally:
        front.stop()
    assert eng.finish_reasons[0] == "finished"
    assert_blocks_balanced(eng)


def test_drain_budget_cuts_stragglers(model):
    _, _, tcfg, tp = model
    eng = tengine(tp, tcfg, max_slots=1)
    # every step stalls 20 ms: the 0.2 s budget cannot cover 50 tokens
    eng.injector = FaultInjector([("slow_step", s) for s in range(1, 99)])
    front = HTTPFrontDoor(eng)
    host, port = front.start()
    try:
        s = _post(host, port, {"prompt": prompts(7, 1)[0],
                               "max_new_tokens": 50})
        _read_frames(s, 1)
        front.begin_drain(drain_s=0.2)
        terminal = _frames(_recv_all(s))[-1]
        assert terminal["reason"] == "drained"
        assert 0 < len(terminal["tokens"]) < 50
        assert front.wait_drained(60)
    finally:
        front.stop()
    assert eng.finish_reasons[0] == "drained"
    assert eng.block_accounting()["backed"] == 0
    assert_blocks_balanced(eng)


def test_recovery_emits_retrying_frame_exactly_once(model):
    _, _, tcfg, tp = model
    p = prompts(8, 1)[0]
    ref = tengine(tp, tcfg)
    rid = ref.add_request(list(p), max_new_tokens=12)
    ref_toks = ref.run()[rid]
    eng = tengine(tp, tcfg)
    # a readback crash three steps into the stream
    eng.injector = FaultInjector([("readback_fail", 3)])
    reng = ResilientEngine(eng)
    front = HTTPFrontDoor(reng)
    host, port = front.start()
    try:
        raw = _recv_all(_post(host, port, {"prompt": p,
                                           "max_new_tokens": 12}))
        body = _split(raw)[1]
        assert sse_retry_frame(1) in body
        frames = _frames(body)
        terminal = frames[-1]
        assert terminal["reason"] == "finished"
        assert [f["token"] for f in frames if "token" in f] \
            == terminal["tokens"] == ref_toks
        assert reng.recoveries == 1
    finally:
        front.stop()
    assert_blocks_balanced(eng)


# ---------------------------------------------------------------------------
# telemetry routes
# ---------------------------------------------------------------------------
TELEMETRY = ("/metrics", "/metrics.json", "/fleet/metrics",
             "/fleet/replicas.json", "/fleet/placements.json",
             "/alerts.json")


def test_telemetry_routes_503_while_obs_off_then_served(model):
    _, _, tcfg, tp = model
    eng = tengine(tp, tcfg)
    front = HTTPFrontDoor(eng)
    host, port = front.start()
    try:
        assert not tobs.enabled()
        for path in TELEMETRY:
            raw = _get(host, port, path)
            assert _status(raw) == 503, path
            assert b"FLAGS_obs_enabled" in _split(raw)[1]
        tobs.get_registry().reset()
        tobs.enable()
        try:
            raw = _recv_all(_post(host, port, {
                "prompt": [1, 2, 3], "max_new_tokens": 3,
                "stream": False}))
            assert _status(raw) == 200
            text = _split(_get(host, port, "/metrics"))[1].decode()
            assert 'serving_http_requests_total{code="200"' in text
            assert "serving_tokens_total" in text
            for path in TELEMETRY[1:]:
                raw = _get(host, port, path)
                assert _status(raw) == 200, path
            alerts = json.loads(_split(_get(host, port, "/alerts.json"))[1])
            assert alerts["version"] == 1 and "alerts" in alerts
            assert _status(_recv_all(_post(
                host, port, None, raw_body=b"{}"))) == 400
        finally:
            tobs.disable()
            tobs.get_registry().reset()
    finally:
        front.stop()


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------
def test_serve_cli_cpu_drains_on_sigint():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.tools.serve",
         "--device", "cpu", "--port", "0", "--vocab", "64",
         "--hidden", "32", "--layers", "1", "--max-len", "64",
         "--block-size", "8", "--max-slots", "2",
         "--flags", "serve_drain_s=10"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO,
        env=env)
    try:
        port = None
        for line in proc.stdout:
            m = re.search(rb"serving on http://127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "the server never printed its address"
        assert _status(_get("127.0.0.1", port, "/healthz")) == 200
        raw = _recv_all(_post("127.0.0.1", port, {
            "prompt": [1, 2, 3], "max_new_tokens": 4}))
        terminal = _frames(_split(raw)[1])[-1]
        assert terminal["reason"] == "finished"
        assert len(terminal["tokens"]) == 4
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0, out[-2000:]
        assert b"drained; bye" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)


def test_front_door_module_is_stdlib_only():
    """The door runs no torch of its own: the step-loop thread calls the
    engine, and the module imports only the standard library and the
    port's stdlib-only pieces."""
    import ast

    tree = ast.parse(open(thttp.__file__).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            roots.add(node.module.split(".")[0])
    assert roots <= {"asyncio", "collections", "json", "math", "threading",
                     "time", "typing", "__future__", "paddle_tpu_torch"}
    assert "torch" not in roots and "numpy" not in roots

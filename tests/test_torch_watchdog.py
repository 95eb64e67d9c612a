"""The port's comm/step watchdog (paddle_tpu_torch.distributed.watchdog)
held to the JAX package's on the CPU: the reference's log-mode,
completed-task, no-install and install-guard cases, run through both
packages with the same flight events and metrics, plus the emergency-hook
registry the front door's drain and the router's ``drain_all`` flush
through. The elastic-restart case waits for the port's launcher."""
import threading

import pytest

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import paddle_tpu.distributed.watchdog as jwd
import paddle_tpu_torch.distributed.watchdog as twd
from test_torch_fleet import events, pair  # noqa: F401

WATCHDOGS = {"paddle_tpu": jwd, "paddle_tpu_torch": twd}


def _fire_once(p, wd_mod):
    """One guarded region that outlives its timeout in log mode; the
    run's observable record."""
    hit = threading.Event()
    hits = []

    def on_timeout(name, elapsed):
        hits.append((name, elapsed))
        hit.set()

    wd = wd_mod.CommWatchdog(timeout=0.2, mode="log", poll=0.02,
                             on_timeout=on_timeout)
    try:
        with wd.task("hung-collective"):
            assert hit.wait(60)
    finally:
        wd.stop()
    ev = [{k: v for k, v in e.items() if k != "elapsed"}
          for e in events(p) if e["kind"] == "watchdog_timeout"]
    reg = p.obs.get_registry()
    return {"hits": [n for n, _ in hits], "elapsed_ok": hits[0][1] >= 0.2,
            "events": ev, "fired": [n for n, _ in wd._fired],
            "timeouts": reg.counter("watchdog_timeouts_total")
            .labels().value}


def test_timeout_fires_in_log_mode_as_reference(pair):
    got = [_fire_once(p, WATCHDOGS[p.name]) for p in pair]
    assert got[1] == got[0]
    assert got[1]["hits"] == ["hung-collective"] and got[1]["elapsed_ok"]
    assert got[1]["events"] == [{"kind": "watchdog_timeout",
                                 "task": "hung-collective",
                                 "timeout": 0.2, "mode": "log"}]
    assert got[1]["timeouts"] == 1


def test_heartbeat_gauge_tracks_the_oldest_guarded_region(pair):
    p = pair[1]
    wd = twd.CommWatchdog(timeout=60.0, mode="log", poll=0.01)
    gauge = p.obs.get_registry().gauge("watchdog_heartbeat_age_seconds")
    try:
        pause = threading.Event()
        with wd.task("slow-readback"):
            # the monitor stamps the age of the region in flight
            while gauge.labels().value <= 0:
                pause.wait(0.01)
        while gauge.labels().value != 0.0:    # nothing blocked again
            pause.wait(0.01)
    finally:
        wd.stop()
    assert wd._fired == []


@pytest.mark.parametrize("wd_mod", [jwd, twd], ids=["jax", "torch"])
def test_completed_task_never_fires(wd_mod):
    hits = []
    wd = wd_mod.CommWatchdog(timeout=30.0, mode="log", poll=0.01,
                             on_timeout=lambda n, e: hits.append(n))
    try:
        for _ in range(3):
            with wd.task("fast"):
                pass
        threading.Event().wait(0.2)           # monitor passes over nothing
    finally:
        wd.stop()
    assert hits == [] and wd._tasks == {}


@pytest.mark.parametrize("wd_mod", [jwd, twd], ids=["jax", "torch"])
def test_guarded_noop_without_install(wd_mod):
    with wd_mod.guarded("nothing-installed"):
        pass
    assert wd_mod.current() is None


@pytest.mark.parametrize("wd_mod", [jwd, twd], ids=["jax", "torch"])
def test_install_guard_fires(wd_mod):
    hits = []
    hit = threading.Event()
    first = wd_mod.install(timeout=60.0, mode="log")
    wd = wd_mod.CommWatchdog(timeout=0.1, mode="log", poll=0.02,
                             on_timeout=lambda n, e: (hits.append(n),
                                                      hit.set()))
    try:
        assert wd_mod.install(wd) is wd and wd_mod.current() is wd
        assert not first._thread.is_alive()   # the replaced one stopped
        with wd_mod.guarded("slow-region"):
            assert hit.wait(60)
    finally:
        wd_mod.uninstall()
    assert hits == ["slow-region"] and wd_mod.current() is None


@pytest.mark.parametrize("wd_mod", [jwd, twd], ids=["jax", "torch"])
def test_emergency_hooks_run_in_order_and_survive_a_raise(wd_mod, capfd):
    calls = []

    def bad(name, elapsed):
        raise RuntimeError("flush failed")

    hooks = [wd_mod.register_emergency_hook(
        lambda n, e: calls.append(("a", n, e))),
        wd_mod.register_emergency_hook(bad),
        wd_mod.register_emergency_hook(
            lambda n, e: calls.append(("b", n, e)))]
    try:
        wd_mod.run_emergency_hooks("http-drain", 1.5)
    finally:
        for fn in hooks:
            wd_mod.unregister_emergency_hook(fn)
    wd_mod.unregister_emergency_hook(bad)     # twice: a no-op
    assert calls == [("a", "http-drain", 1.5), ("b", "http-drain", 1.5)]
    assert "flush failed" in capfd.readouterr().err
    # a hook that hangs cannot hold the caller past the budget
    release = threading.Event()
    fn = wd_mod.register_emergency_hook(lambda n, e: release.wait(60))
    try:
        wd_mod.run_emergency_hooks("router-drain", budget=0.05)
    finally:
        release.set()
        wd_mod.unregister_emergency_hook(fn)
    assert "still running" in capfd.readouterr().err


def test_exit_code_and_modes_equal_reference():
    assert twd.TEARDOWN_EXIT_CODE == jwd.TEARDOWN_EXIT_CODE == 77
    assert twd.__all__ == jwd.__all__
    for mod in (jwd, twd):
        with pytest.raises(ValueError):
            mod.CommWatchdog(mode="abort")


@pytest.mark.skip(reason="the elastic-restart feed (teardown -> dead-pod "
                  "watcher -> restart) reads the port's launcher, which "
                  "comes with ROADMAP A10")
def test_teardown_feeds_elastic_restart():
    pass

"""TCPStore — rendezvous key/value store for multi-process bootstrap; the
port's copy of paddle_tpu/distributed/store.py.

Parity: paddle.distributed.TCPStore over the C++ store
(reference: paddle/phi/core/distributed/store/tcp_store.h:121, socket.cpp;
created by init_parallel_env at parallel.py:1134). The reference runs on
its own native library; the port runs on ``torch.distributed.TCPStore``
(the store torch's own rendezvous uses) with the same methods, the same
``ft_bootstrap_retries`` connect backoff and the same
``dist_store_connect_retries_total`` counter.
"""
from __future__ import annotations

import datetime
from typing import Optional

import torch.distributed as dist

__all__ = ["TCPStore"]


class TCPStore:
    """parity: paddle.distributed.TCPStore(host, port, is_master, world_size,
    timeout)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = False, world_size: int = 1,
                 timeout: float = 30.0, bind_addr: str = "",
                 retries: int = None):
        """The master starts the server (``port`` 0 picks a free port,
        read back from ``.port``); every other process connects to
        ``host:port``. ``bind_addr``: torch's store server listens on
        every interface, so only ``""`` (the reference's default) is
        taken — a narrower bind raises rather than listen wider than
        asked.

        The client connect retries with exponential backoff (``retries``,
        default ``FLAGS_ft_bootstrap_retries``); the caller's ``timeout``
        is SPLIT across attempts, so total connect wall time stays ~one
        ``timeout``. Each attempt opens a fresh connection (a half-open
        connection to a restarted master never recovers)."""
        from ..framework.flags import get_flag
        from .resilience.retry import retry_call

        if bind_addr:
            raise NotImplementedError(
                f"TCPStore: bind_addr={bind_addr!r}: torch's store server "
                "listens on every interface and cannot be narrowed")
        self.host = host
        self._timeout = datetime.timedelta(seconds=float(timeout))
        self._client = None
        if is_master:
            self._client = dist.TCPStore(host, port, world_size, True,
                                         timeout=self._timeout,
                                         wait_for_workers=False)
            self.port = self._client.port
            return
        self.port = port
        if retries is None:
            retries = get_flag("ft_bootstrap_retries")
        per_attempt = datetime.timedelta(
            seconds=max(1.0, float(timeout) / (retries + 1)))

        def connect():
            try:
                client = dist.TCPStore(host, port, world_size, False,
                                       timeout=per_attempt)
            except (RuntimeError, dist.DistError) as e:
                raise ConnectionError(
                    f"TCPStore: cannot connect {host}:{port} ({e})") from e
            client.set_timeout(self._timeout)
            return client

        from ..observability.catalog import instrument

        retry_counter = instrument("dist_store_connect_retries_total")
        self._client = retry_call(
            connect, retries=retries, exceptions=(ConnectionError,),
            on_retry=lambda attempt, exc: retry_counter.inc())

    def _store(self):
        if self._client is None:
            raise RuntimeError("TCPStore is closed")
        return self._client

    def set(self, key: str, value) -> None:
        data = value if isinstance(value, bytes) else str(value).encode()
        self._store().set(key, data)

    def get(self, key: str) -> Optional[bytes]:
        """The value under ``key``, or None when it is not set (no wait)."""
        st = self._store()
        if not st.check([key]):
            return None
        return st.get(key)

    def wait(self, key: str) -> bytes:
        st = self._store()
        try:
            st.wait([key])
        except (RuntimeError, dist.DistError) as e:
            raise RuntimeError(f"TCPStore.wait failed ({e})") from e
        return st.get(key)

    def add(self, key: str, amount: int = 1) -> int:
        return int(self._store().add(key, amount))

    def gather(self, prefix: str, rank: int, world_size: int,
               value) -> list:
        """All-gather through the store: publish ``value`` under
        ``prefix/<rank>`` and return every rank's value (list of bytes,
        rank order), blocking until all ``world_size`` are set."""
        self.set(f"{prefix}/{rank}", value)
        return [self.wait(f"{prefix}/{r}") for r in range(world_size)]

    def barrier(self, key: str, world_size: int) -> None:
        """All participants call with the same key; returns when world_size
        have arrived."""
        n = self.add(key + "/count", 1)
        if n >= world_size:
            self.set(key + "/done", b"1")
        self.wait(key + "/done")

    def close(self) -> None:
        # torch's store closes its socket (and a master its server) when
        # the last reference goes
        self._client = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

"""Clients of the serving tier.

The port of ``netrep_tpu/serve/client.py`` (host code):

- :class:`InProcessClient` — wraps a live
  :class:`~netrep_tpu_torch.serve.scheduler.PreservationServer` directly:
  zero transport, numpy in/out.
- :class:`SocketClient` — line-delimited JSON over the daemon's unix
  socket (:mod:`netrep_tpu_torch.serve.server`); arrays travel as nested
  lists, responses come back with arrays re-materialized as numpy.

Retry-with-backoff: both clients' ``analyze`` take ``retries=N``. Every
attempt of one logical request carries the SAME idempotency key
(auto-generated when the caller passes none), so a retry after a
``QueueFull``/brownout rejection, a dropped connection, or a server
restart can never recompute or double-run. Backoff is exponential with
DETERMINISTIC jitter: the jitter factor hashes ``(key, attempt)``
(:func:`retry_delay`, the JAX package's numbers), so a rerun of the same
client schedule sleeps the same delays. A server-supplied
``retry_after_s`` hint takes precedence over the computed delay.
"""

from __future__ import annotations

import hashlib
import json
import socket
import time
import uuid

from .protocol import decode_arrays, encode_arrays, mint_trace_ctx


class ServeRejected(RuntimeError):
    """The daemon refused the request with a retryable rejection
    (``QueueFull``/brownout): back off — ``retry_after_s`` is the
    server's drain-time hint when it has one. ``redirect`` (a fleet
    coordinator's routing answer) names another socket the client should
    re-send the SAME op to — a routing hint, not an overload signal, so
    the retry is immediate."""

    def __init__(self, msg: str, retry_after_s: float | None = None,
                 redirect: str | None = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s
        self.redirect = redirect


def retry_delay(attempt: int, token: str, base_s: float = 0.25,
                factor: float = 2.0, max_s: float = 10.0,
                jitter: float = 0.25) -> float:
    """Exponential backoff with deterministic jitter, per the
    ``utils/faults.py`` convention: the jitter hashes ``(token,
    attempt)`` so identical retry schedules sleep identically (no hidden
    RNG state — reproducible load-generator traces)."""
    d = min(max_s, base_s * factor ** (max(1, attempt) - 1))
    if jitter:
        h = int.from_bytes(
            hashlib.blake2b(f"{token}:{attempt}".encode(),
                            digest_size=8).digest(),
            "big",
        )
        d *= 1.0 + jitter * (h / float(2 ** 64) * 2.0 - 1.0)
    return max(0.0, d)


class InProcessClient:
    """Direct (same-process) client — the canonical programmatic surface::

        from netrep_tpu_torch.serve import (
            InProcessClient, PreservationServer, ServeConfig)
        client = InProcessClient(PreservationServer(ServeConfig()))
        client.register_dataset("acme", "d", network=..., correlation=...,
                                data=..., assignments=labels)
        client.register_dataset("acme", "t", network=..., correlation=...,
                                data=...)
        res = client.analyze("acme", "d", "t", n_perm=2000, seed=1)
        res["p_values"]   # equal to module_preservation(...)
    """

    def __init__(self, server):
        self.server = server

    def register_tenant(self, name: str, weight: int = 1) -> None:
        self.server.register_tenant(name, weight)

    def register_dataset(self, tenant: str, name: str, **kw) -> str:
        return self.server.register_dataset(tenant, name, **kw)

    def register_fixture(self, tenant: str, prefix: str = "fx", **kw) -> dict:
        return self.server.register_fixture(tenant, prefix, **kw)

    def submit(self, tenant: str, discovery: str, test, **kw):
        """Non-blocking submit; returns the request handle for
        :meth:`result`. Mints a trace context unless the
        caller supplies its own — the id the request's whole span
        subtree carries, across processes and server restarts."""
        kw.setdefault("trace_ctx", mint_trace_ctx())
        return self.server.submit(tenant, discovery, test, **kw)

    def result(self, handle, timeout: float | None = None) -> dict:
        return self.server.wait(handle, timeout=timeout)

    def analyze(self, tenant: str, discovery: str, test, *,
                timeout: float | None = None, retries: int = 0,
                retry_base_s: float = 0.25, sleep=time.sleep,
                **kw) -> dict:
        """Blocking submit + wait. With ``retries`` > 0, an admission
        rejection (``QueueFull``, incl. brownout shedding) is retried
        with deterministic backoff under ONE idempotency key — the
        server's ``retry_after_s`` hint, when present, wins over the
        computed delay. Safe by construction: the key dedups every
        attempt onto one computation. The trace context, like
        the idempotency key, is minted ONCE per logical request — every
        retry carries the same trace id."""
        from .scheduler import QueueFull

        key = kw.setdefault("idempotency_key", f"c-{uuid.uuid4().hex}")
        kw.setdefault("trace_ctx", mint_trace_ctx())
        attempt = 0
        while True:
            try:
                return self.server.analyze(tenant, discovery, test,
                                           timeout=timeout, **kw)
            except QueueFull as e:
                attempt += 1
                if attempt > retries:
                    raise
                delay = retry_delay(attempt, key, base_s=retry_base_s)
                if e.retry_after_s is not None:
                    delay = max(delay, float(e.retry_after_s))
                sleep(delay)

    def metrics(self) -> str:
        return self.server.metrics_text()

    def stats(self) -> dict:
        return self.server.stats()


class SocketClient:
    """Line-delimited JSON client for the unix-socket daemon
    (:func:`netrep_tpu_torch.serve.server.serve_daemon` with a
    ``socket``)."""

    def __init__(self, path: str, timeout: float = 120.0):
        self.path = path
        self._timeout = timeout
        self._connect()

    def _connect(self) -> None:
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.settimeout(self._timeout)
        self._sock.connect(self.path)
        self._rfile = self._sock.makefile("r", encoding="utf-8")

    def reconnect(self) -> None:
        """Drop and re-dial the socket — the retry path after the daemon
        restarted (a recovering boot); the idempotency key makes the
        re-sent request safe."""
        try:
            self.close()
        except OSError:
            pass
        self._connect()

    def request(self, op: str, **kw) -> dict:
        payload = encode_arrays({"op": op, **kw})
        self._sock.sendall((json.dumps(payload) + "\n").encode("utf-8"))
        line = self._rfile.readline()
        if not line:
            raise ConnectionError("serve daemon closed the connection")
        resp = json.loads(line)
        if not resp.get("ok", False):
            if resp.get("retryable") or resp.get("redirect"):
                raise ServeRejected(
                    resp.get("error", "serve daemon rejected the request"),
                    retry_after_s=resp.get("retry_after_s"),
                    redirect=resp.get("redirect"),
                )
            raise RuntimeError(resp.get("error", "serve daemon error"))
        return decode_arrays(resp)

    def ping(self) -> dict:
        return self.request("ping")

    def register_fixture(self, tenant: str, prefix: str = "fx", **kw) -> dict:
        return self.request("register_fixture", tenant=tenant,
                            prefix=prefix, **kw)["fixture"]

    def register_dataset(self, tenant: str, name: str, **kw) -> str:
        return self.request("register", tenant=tenant, name=name,
                            **kw)["digest"]

    def analyze(self, tenant: str, discovery: str, test, *,
                retries: int = 0, retry_base_s: float = 0.25,
                sleep=time.sleep, **kw) -> dict:
        """Blocking analyze over the socket. With ``retries`` > 0, a
        retryable rejection (QueueFull/brownout — honoring the server's
        ``retry_after_s`` hint) or a dropped/restarted daemon connection
        is retried under ONE idempotency key: after a recovering boot —
        or a fleet replica failover — the re-sent request is answered from the journal (or attaches to its
        re-queued run) instead of recomputing. A coordinator
        ``redirect`` hint re-points the connection at the named socket
        and re-sends IMMEDIATELY (it is routing, not overload, so it
        costs no retry attempt; hops are bounded). The trace context is
        minted once per logical request: every attempt —
        across reconnects, redirects, and daemon restarts — carries the
        same trace id, so the merged trace is one story."""
        key = kw.setdefault("idempotency_key", f"c-{uuid.uuid4().hex}")
        kw.setdefault("trace_ctx", mint_trace_ctx())
        attempt = 0
        hops = 0
        while True:
            try:
                return self.request("analyze", tenant=tenant,
                                    discovery=discovery, test=test,
                                    **kw)["result"]
            except (ServeRejected, ConnectionError, OSError) as e:
                if getattr(e, "redirect", None) and hops < 8:
                    # routing hint: follow to the named replica socket
                    # under the SAME key/trace, no backoff consumed
                    hops += 1
                    self.path = e.redirect
                    try:
                        self.reconnect()
                        continue
                    except OSError:
                        pass   # fall through to the retry ladder
                attempt += 1
                if attempt > retries:
                    raise
                delay = retry_delay(attempt, key, base_s=retry_base_s)
                if getattr(e, "retry_after_s", None) is not None:
                    delay = max(delay, float(e.retry_after_s))
                sleep(delay)
                if not isinstance(e, ServeRejected):
                    try:
                        self.reconnect()
                    except OSError:
                        continue  # daemon still down — next attempt re-dials

    def metrics(self) -> str:
        return self.request("metrics")["text"]

    def stats(self) -> dict:
        return self.request("stats")["stats"]

    def shutdown(self) -> dict:
        return self.request("shutdown")

    def close(self) -> None:
        try:
            self._rfile.close()
        finally:
            self._sock.close()

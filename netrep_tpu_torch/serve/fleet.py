"""Fleet serving: replicated servers behind one coordinator.

The port of ``netrep_tpu/serve/fleet.py``, in process. One server is one
worker; a fleet puts N replicas behind a router. Requests are durable and
idempotent (the write-ahead journal), served results equal each request's
solo call under any pack or replica composition, and pack checkpoints are
identity-keyed, so serve work can migrate; this module migrates it when a
replica dies or leaves::

    client ──► FleetCoordinator ──► replica r0 (journal J0)
                │  consistent-hash   replica r1 (journal J1)
                │  ring on dataset    ...
                │  digests            replica rN
                ├─ JournalShipper per replica: J_i tails to the
                │  designated peer's copy (acked offsets, torn-line
                │  tolerant)
                └─ health loop → failover

- **Routing**: the (discovery digest, test digest) key consistent-hashes
  onto the replica ring (blake2b, 64 virtual nodes a replica): the same
  dataset pair always lands on the same replica, so its warm
  ``ProgramPool`` engines keep hitting. The hash reads content digests
  only, and a registration's digest is the JAX package's, so a pair lands
  on the same replica id in both packages. Registrations broadcast to
  every replica (any replica may inherit any pair).
- **Journal shipping**: each replica's journal ships to a copy under
  ``<fleet_dir>/ship/<rid>.jsonl`` that its ring successor adopts.
- **Failover**: the health loop (or :meth:`FleetCoordinator.kill_replica`)
  declares a replica dead, removes it from the ring, runs a final ship
  pass, gives its warm pool's device memory back, and has the peer
  ``adopt_journal`` the shipped copy: duplicates answer from journaled
  results, unfinished requests re-queue in original order and resume
  their packs from the SHARED checkpoint directory at the last chunk
  boundary.
- **Planned departures** (:meth:`FleetCoordinator.retire_replica`,
  :meth:`~FleetCoordinator.evict_notice`): ring removal first, a bounded
  drain, the journal tail pre-shipped, then peer adoption — a handoff
  that recomputes nothing.
- **Fleet-wide admission**: brownout reads the AGGREGATE backlog-drain
  estimate — queued permutations summed across replicas over the summed
  per-replica rates (measured, else the shared perf ledger's serve
  history).
- **Autoscaling** (:class:`Autoscaler`): scale up on backlog, retire idle
  replicas, scale to zero and spawn on demand.

Two kinds of replica stand behind one coordinator:

- **In process** (:func:`build_inprocess_fleet`): servers on
  ``ServeConfig.device`` (None means ``"cuda"``; the default config
  raises ``RuntimeError`` without a card); pass ``device="cpu"`` through
  ``make_config`` to run on the CPU. Every replica's worker shares the one
  card; each replica's fault runtime (``arm_fault_plan``) is its own.
- **Daemons** (:func:`fleet_daemon`, ``python -m netrep_tpu_torch serve
  --fleet N``): each replica a ``serve`` process on its own unix socket
  (:class:`DaemonReplica`), started with the coordinator's ``--device``
  (the card unless ``--device cpu``), respawned under a new generation
  (``r0`` → ``r0.g1``) after its failover unless ``--no-respawn``. The
  coordinator only routes and ships journals: it creates no CUDA context.

What the port does its own way:

- A dead replica's device memory is given back at failover, after the
  final ship pass: an in-process replica's warm pool is released without
  draining (the JAX package leaves a dead in-process replica's engines in
  place), a daemon declared dead is killed if it still runs, so the
  peer's engines do not stack on the dead one's.
- :class:`InProcessReplica` answers :meth:`~InProcessReplica.forward`, so
  :func:`dispatch_fleet_op` proxies every op to in-process replicas too.
- Daemon replicas take a broadcast registration all at once (each is a
  process of its own); the JAX coordinator registers on one after another.
- A respawned daemon adopts the registrations (datasets only) from a live
  peer's shipped journal before it joins the ring, as an autoscaled spawn
  does; the JAX respawn joins without them, so a pair routed to it is
  unknown there.

A departed replica (failover or eviction) leaves a diagnostic bundle
under ``<fleet_dir>/bundles/`` (:meth:`FleetCoordinator._collect_bundle`),
and each replica row of :meth:`FleetCoordinator.stats` carries its
server's roofline ``utilisation``: the most recent run on that server's
own telemetry bus (null for a replica without one).
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import json
import logging
import os
import socket as _socket
import threading
import time
import uuid

from ..utils import telemetry as tm
from . import lifecycle as lc
from .journal import JournalShipper
from .lifecycle import ReplicaLifecycle
from .scheduler import PreservationServer, QueueFull, ServeConfig, ServeError

logger = logging.getLogger("netrep_tpu_torch")


class ReplicaLost(ServeError):
    """The replica holding this request died mid-flight. The coordinator
    catches this, waits for failover to complete, and re-routes under the
    SAME idempotency key — the peer either attaches to the adopted
    (re-queued) computation or answers from the shipped journal."""


class HashRing:
    """Consistent-hash ring with virtual nodes: dataset-pair digests map to
    replicas such that membership changes move ONLY the keys owned by the
    joining/leaving replica. Deterministic — placement is a pure function
    of (members, key)."""

    def __init__(self, vnodes: int = 64):
        self.vnodes = max(1, int(vnodes))
        self._points: list[tuple[int, str]] = []   # sorted (hash, rid)

    @staticmethod
    def _hash(s: str) -> int:
        return int.from_bytes(
            hashlib.blake2b(s.encode(), digest_size=8).digest(), "big"
        )

    def add(self, rid: str) -> None:
        for i in range(self.vnodes):
            bisect.insort(self._points, (self._hash(f"{rid}#{i}"), rid))

    def remove(self, rid: str) -> None:
        self._points = [p for p in self._points if p[1] != rid]

    def members(self) -> set[str]:
        return {rid for _h, rid in self._points}

    def route(self, key: str) -> str | None:
        """The replica owning ``key``: first ring point at or past the
        key's hash, wrapping at the top."""
        if not self._points:
            return None
        h = self._hash(key)
        i = bisect.bisect_left(self._points, (h, ""))
        if i >= len(self._points):
            i = 0
        return self._points[i][1]

    def successor(self, rid: str) -> str | None:
        """The next DISTINCT replica clockwise from ``rid``'s first point —
        the designated journal-ship peer."""
        if not self._points:
            return None
        first = None
        for h, r in self._points:
            if r == rid:
                first = h
                break
        if first is None:
            return None
        n = len(self._points)
        i = bisect.bisect_right(self._points, (first, rid))
        for step in range(n):
            r = self._points[(i + step) % n][1]
            if r != rid:
                return r
        return None


@dataclasses.dataclass
class FleetConfig:
    """Coordinator knobs (the JAX package's fields and defaults)."""

    #: health-loop poll interval; a replica is declared dead on the first
    #: failed liveness check
    heartbeat_s: float = 0.25
    #: journal-ship tail interval per replica
    ship_interval_s: float = 0.2
    #: virtual nodes per replica on the hash ring
    vnodes: int = 64
    #: fleet-wide brownout: shed new admissions when the AGGREGATE backlog
    #: drain estimate exceeds this (None = off); exit below
    #: ``brownout_exit_s`` (default half)
    brownout_enter_s: float | None = None
    brownout_exit_s: float | None = None
    #: assumed per-replica steady rate before anything is measured (else
    #: each replica's own estimate, else the shared perf ledger)
    rate_pps: float | None = None
    #: where shipped journal copies live: ``<fleet_dir>/ship/<rid>.jsonl``
    fleet_dir: str | None = None
    #: coordinator telemetry (fleet events land here): path / Telemetry /
    #: True / None — same resolution as ``ServeConfig.telemetry``
    telemetry: object = None
    #: bound on each replica's drain when the fleet closes
    drain_timeout_s: float = 120.0
    #: how long a re-routed request waits for an in-progress failover
    failover_wait_s: float = 60.0


class InProcessReplica:
    """One in-process fleet replica: a journaled
    :class:`~netrep_tpu_torch.serve.scheduler.PreservationServer` plus the
    liveness and drill seams the coordinator drives."""

    def __init__(self, rid: str, server: PreservationServer,
                 generation: int = 0):
        self.rid = rid
        self.server = server
        self.journal_path = server.config.journal
        #: the state machine every membership change routes through
        self.lifecycle = ReplicaLifecycle(rid, generation=generation)
        #: set by the coordinator once failover for this replica is
        #: underway — in-flight ``analyze`` waiters stop waiting on the
        #: dead worker and re-route
        self.dead = threading.Event()

    @property
    def tel(self):
        """The server's telemetry bus (what :func:`~netrep_tpu_torch.serve.
        server.dispatch_op` reports malformed ops on)."""
        return self.server.tel

    def alive(self) -> bool:
        w = self.server._worker
        return w is not None and w.is_alive() and not self.dead.is_set()

    def arm_fault_plan(self, policy) -> None:
        """Drill hook: arm a fault policy — e.g. ``FaultPolicy(plan=
        "crash@640")``, the in-process stand-in for a killed process — on
        the live server. Drills route first, then arm the replica that
        owns the pair, so the kill lands on the replica actually
        serving."""
        from ..utils.faults import resolve_runtime

        self.server._fault = resolve_runtime(policy)

    # -- ops ---------------------------------------------------------------

    def register_tenant(self, name: str, weight: int = 1) -> None:
        self.server.register_tenant(name, weight)

    def register_dataset(self, tenant: str, name: str, **kw) -> str:
        return self.server.register_dataset(tenant, name, **kw)

    def register_fixture(self, tenant: str, prefix: str = "fx",
                         **kw) -> dict:
        return self.server.register_fixture(tenant, prefix, **kw)

    def analyze(self, tenant: str, discovery: str, test, *,
                timeout: float | None = None, **kw) -> dict:
        """Blocking analyze that stays responsive to replica death: the
        wait polls so a mid-flight loss raises :class:`ReplicaLost`
        instead of blocking on a request whose worker no longer exists."""
        handle = self.server.submit(tenant, discovery, test, **kw)
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while not handle.done.wait(0.1):
            if self.dead.is_set():
                raise ReplicaLost(
                    f"replica {self.rid} died while serving the request"
                )
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"request did not finish on replica {self.rid}"
                )
        if handle.requeued_on_drain:
            # a bounded drain (eviction grace) journaled this request as
            # requeued instead of finishing it — inside a fleet that is a
            # migration: the peer adopts the journaled record, so re-route
            # under the same idempotency key
            raise ReplicaLost(
                f"replica {self.rid} drained away mid-request; the "
                f"journaled record migrates with the handoff"
            )
        return self.server.wait(handle, timeout=0)

    def forward(self, op: dict) -> dict:
        """One wire op answered as the replica's daemon would answer it
        (:func:`~netrep_tpu_torch.serve.server.dispatch_op` over this
        replica) — what :func:`dispatch_fleet_op` proxies to. A
        :class:`ReplicaLost` answer raises ``ConnectionError``, as a
        daemon's closed socket does, so the proxy waits for the failover
        and re-routes."""
        from .server import dispatch_op

        resp = dispatch_op(self, op, threading.Event())
        if not resp.get("ok", False) and str(
                resp.get("error", "")).startswith("ReplicaLost:"):
            raise ConnectionError(resp["error"])
        return resp

    def adopt_journal(self, path: str, datasets_only: bool = False):
        return self.server.adopt_journal(path, datasets_only=datasets_only)

    def stats(self) -> dict:
        return self.server.stats()

    def metrics_text(self) -> str:
        return self.server.metrics_text()

    def release(self) -> None:
        """Give back the device memory of a dead replica's warm pool
        without draining it, and its hold on the process's registration
        copies. Only once its worker has exited: a worker still running
        holds its pack's engine."""
        w = self.server._worker
        if w is None or not w.is_alive():
            self.server.pool.clear()
            self.server.drop_registrations()

    def close(self, drain: bool = True,
              timeout: float | None = None) -> None:
        self.server.close(drain=drain, timeout=timeout)


def _wire_line(path: str, payload: dict, timeout: float = 600.0) -> dict:
    """One raw request/response line over a unix socket — the
    coordinator's proxy primitive: the client's op forwards VERBATIM
    (idempotency keys and trace ids pass through unchanged) and the
    replica's response returns verbatim."""
    s = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
    s.settimeout(timeout)
    try:
        s.connect(path)
        s.sendall((json.dumps(payload) + "\n").encode("utf-8"))
        f = s.makefile("r", encoding="utf-8")
        line = f.readline()
        if not line:
            raise ConnectionError("replica closed the connection")
        return json.loads(line)
    finally:
        s.close()


class DaemonReplica:
    """A replica daemon: a ``python -m netrep_tpu_torch serve`` process on
    its own unix socket. Each op opens a short-lived connection (unix
    connects are microseconds, and per-op connections keep the proxy
    thread-safe without a pool)."""

    def __init__(self, rid: str, socket_path: str, journal_path: str,
                 proc=None, timeout: float = 600.0, generation: int = 0,
                 out_path: str | None = None):
        self.rid = rid
        self.socket_path = socket_path
        self.journal_path = journal_path
        self.proc = proc
        self.timeout = timeout
        #: where the daemon's standard output goes (its ``ready`` line)
        self.out_path = out_path
        #: wall clock of the spawn (the ``ready`` line's boot split is on
        #: the same clock)
        self.spawned_t = time.time()
        self.lifecycle = ReplicaLifecycle(rid, generation=generation)
        self.dead = threading.Event()

    def forward(self, op: dict) -> dict:
        """Raw proxy: the op forwards verbatim, the response comes back
        verbatim (whatever ``ok`` it carries)."""
        return _wire_line(self.socket_path, op, self.timeout)

    def request(self, op_name: str, **kw) -> dict:
        resp = self.forward({"op": op_name, **kw})
        if not resp.get("ok", False):
            raise ServeError(f"replica {self.rid} {op_name}: "
                             f"{resp.get('error', 'unknown error')}")
        return resp

    def ready_line(self) -> dict | None:
        """The daemon's ``ready`` line (with its boot split), once it has
        printed one."""
        if not self.out_path:
            return None
        try:
            with open(self.out_path, encoding="utf-8") as f:
                for line in f:
                    if line.startswith("{"):
                        rec = json.loads(line)
                        if rec.get("serve") == "ready":
                            return rec
        except (OSError, ValueError):
            return None
        return None

    def alive(self) -> bool:
        if self.dead.is_set():
            return False
        if self.proc is not None and self.proc.poll() is not None:
            return False
        try:
            # a short-fused ping: liveness answers in heartbeats, not the
            # data plane's timeout — a wedged-but-listening daemon is as
            # dead as a closed socket
            resp = _wire_line(self.socket_path, {"op": "ping"}, timeout=2.0)
            return bool(resp.get("pong"))
        except (OSError, ValueError):
            return False

    # -- ops ---------------------------------------------------------------

    def register_tenant(self, name: str, weight: int = 1) -> None:
        # the wire creates tenants implicitly at weight 1; an explicit
        # weight has no wire op
        pass

    def register_dataset(self, tenant: str, name: str, **kw) -> str:
        from .client import SocketClient

        c = SocketClient(self.socket_path, timeout=self.timeout)
        try:
            return c.register_dataset(tenant, name, **kw)
        finally:
            c.close()

    def register_fixture(self, tenant: str, prefix: str = "fx",
                         **kw) -> dict:
        from .client import SocketClient

        c = SocketClient(self.socket_path, timeout=self.timeout)
        try:
            return c.register_fixture(tenant, prefix, **kw)
        finally:
            c.close()

    def analyze(self, tenant: str, discovery: str, test, *,
                timeout: float | None = None, **kw) -> dict:
        from .client import SocketClient

        try:
            c = SocketClient(self.socket_path,
                             timeout=timeout or self.timeout)
        except OSError as e:
            raise ReplicaLost(f"replica {self.rid} unreachable") from e
        try:
            return c.analyze(tenant, discovery, test, **kw)
        except OSError as e:
            raise ReplicaLost(
                f"replica {self.rid} died while serving the request"
            ) from e
        finally:
            try:
                c.close()
            except OSError:
                pass

    def adopt_journal(self, path: str, datasets_only: bool = False):
        return self.request("adopt_journal", path=path,
                            datasets_only=datasets_only).get("adopted")

    def stats(self) -> dict:
        return self.request("stats")["stats"]

    def metrics_text(self) -> str:
        return self.request("metrics")["text"]

    def kill(self) -> None:
        """SIGKILL the replica process (drills)."""
        import signal

        if self.proc is not None and self.proc.poll() is None:
            os.kill(self.proc.pid, signal.SIGKILL)

    def release(self) -> None:
        """A daemon declared dead gives its device memory back by exiting:
        one still running (wedged, or past a failed ping) is killed."""
        if self.proc is not None and self.proc.poll() is None:
            self.kill()
            self.proc.wait()

    def close(self, drain: bool = True,
              timeout: float | None = None) -> None:
        import subprocess

        timeout = 120.0 if timeout is None else timeout
        if self.proc is None or self.proc.poll() is not None:
            return
        try:
            if drain:
                self.forward({"op": "shutdown"})
        except (OSError, ValueError):
            pass
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass   # escalate: SIGTERM, then SIGKILL below
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


class FleetCoordinator:
    """The fleet control plane: consistent-hash routing, per-replica
    journal shipping, the health loop, replica-kill failover, planned
    departures and fleet-wide admission (module docstring). Its replicas
    are :class:`InProcessReplica` or :class:`DaemonReplica` handles."""

    def __init__(self, replicas, config: FleetConfig | None = None,
                 start: bool = True):
        self.config = config or FleetConfig()
        self.tel, self._tel_owned = tm.resolve_arg(self.config.telemetry)
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._health: threading.Thread | None = None
        self._replicas: dict[str, InProcessReplica] = {}
        self._dead: set[str] = set()
        #: replicas mid-drain (retire / eviction handoff): off the ring and
        #: invisible to the health loop, but not yet dead
        self._draining: set[str] = set()
        #: the last drained replica's shipped journal copy — the
        #: persistent state a scale-to-zero fleet spawns back from
        self.last_journal: str | None = None
        #: attached :class:`Autoscaler` (None = static fleet); an empty
        #: fleet then spawns on demand instead of rejecting
        self.autoscaler = None
        self._ring = HashRing(self.config.vnodes)
        self._shippers: dict[str, JournalShipper] = {}
        self._peers: dict[str, str] = {}
        self._digests: dict[tuple[str, str], str] = {}
        self._fo_done: dict[str, threading.Event] = {}
        self._brownout = False
        self._ledger_rate: float | None = None
        self._ledger_rate_read = False
        self._started_m = time.monotonic()
        #: optional post-failover hook (the daemon fleet's respawn), called
        #: outside the lock as ``on_failover(rid, peer_rid)``
        self.on_failover = None
        self._serve_sid = None
        if self.tel is not None:
            self._serve_sid = self.tel.begin_span(
                "serve_start", fleet=True, replicas=len(replicas),
            )
        for rep in replicas:
            self.join(rep)
        if start:
            self.start()

    # -- membership --------------------------------------------------------

    def join(self, rep: InProcessReplica) -> None:
        """Admit a replica to the ring (boot, dynamic join, or respawn):
        ring update + shipper start + ``replica_joined``/
        ``ring_rebalanced``; a spawning replica becomes ``ready``."""
        with self._lock:
            self._replicas[rep.rid] = rep
            self._dead.discard(rep.rid)
            self._draining.discard(rep.rid)
            self._ring.add(rep.rid)
            self._fo_done[rep.rid] = threading.Event()
            self._assign_peers_locked()
            members = sorted(self._ring.members())
        rep.lifecycle.bind(self.tel, self._serve_sid)
        if rep.lifecycle.state == lc.SPAWNING:
            rep.lifecycle.transition(lc.READY, reason="join")
        if self.tel is not None:
            self.tel.emit("replica_joined", replica=rep.rid,
                          parent=self._serve_sid,
                          journal=rep.journal_path)
            self.tel.emit("ring_rebalanced", replica=rep.rid,
                          parent=self._serve_sid, reason="join",
                          members=",".join(members))

    def _assign_peers_locked(self) -> None:
        """(Re-)designate each live replica's ship peer (ring successor)
        and make sure its shipper exists. The copy's path is canonical per
        source (``ship/<rid>.jsonl``), so re-designation costs nothing."""
        for rid, rep in self._replicas.items():
            if rid in self._dead or rid in self._draining:
                continue
            self._peers[rid] = self._ring.successor(rid)
            if rid not in self._shippers and rep.journal_path:
                shipper = JournalShipper(
                    rep.journal_path, self._ship_dest(rid),
                    interval_s=self.config.ship_interval_s,
                    replica=rid, telemetry=self.tel,
                )
                self._shippers[rid] = shipper
                if not self._stop.is_set():
                    shipper.start()

    def _ship_dest(self, rid: str) -> str:
        base = self.config.fleet_dir or os.path.join(
            os.getcwd(), "netrep_fleet"
        )
        return os.path.join(base, "ship", f"{rid}.jsonl")

    def live_replicas(self) -> dict[str, InProcessReplica]:
        """Replicas still serving: not dead, not mid-drain."""
        with self._lock:
            return {rid: rep for rid, rep in self._replicas.items()
                    if rid not in self._dead
                    and rid not in self._draining}

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._health is not None:
                return
            self._health = threading.Thread(
                target=self._health_loop, name="netrep-fleet-health",
                daemon=True,
            )
            self._health.start()

    def close(self, drain: bool = True) -> None:
        """Stop the autoscaler and health loop, stop the shippers (final
        ship pass), drain every live replica through the lifecycle
        machine, close the coordinator span/bus."""
        scaler = self.autoscaler
        if scaler is not None:
            scaler.stop()
        self._stop.set()
        with self._lock:
            t, self._health = self._health, None
        if t is not None:
            t.join(timeout=10.0)
        with self._lock:
            shippers = list(self._shippers.values())
            self._shippers.clear()
            live = [rep for rid, rep in self._replicas.items()
                    if rid not in self._dead
                    and rid not in self._draining]
        for s in shippers:
            s.stop(final_flush=True)
        for rep in live:
            cycle = rep.lifecycle
            if cycle.state == lc.READY:
                cycle.transition(lc.DRAINING, reason="fleet_close")
            rep.close(drain=drain, timeout=self.config.drain_timeout_s)
            if cycle.state in (lc.DRAINING, lc.SPAWNING):
                cycle.transition(lc.DEAD, reason="drained")
        if self.tel is not None:
            self.tel.end_span(
                self._serve_sid, "serve_end", fleet=True,
                drained=bool(drain),
                s=time.monotonic() - self._started_m,
            )
            if self._tel_owned:
                self.tel.close()

    # -- health / failover -------------------------------------------------

    def _health_loop(self) -> None:
        while not self._stop.wait(self.config.heartbeat_s):
            for rid, rep in self.live_replicas().items():
                if self._stop.is_set():
                    return
                if not rep.alive():
                    self._failover(rid)

    def _failover(self, rid: str) -> None:
        """Replica death → journal-ship catch-up → pool released → peer
        adoption. The peer's ``adopt_journal`` runs the recovering boot's
        replay over the shipped copy: duplicates answer from journaled
        results, unfinished requests re-queue in original order and
        resume their packs from the SHARED checkpoint directory."""
        t0 = time.perf_counter()
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None or rid in self._dead:
                return
            self._dead.add(rid)
            self._ring.remove(rid)
            shipper = self._shippers.pop(rid, None)
            peer_rid = self._peers.pop(rid, None)
            if peer_rid is None or peer_rid in self._dead:
                peer_rid = self._ring.route(rid)   # any survivor
            peer = (self._replicas.get(peer_rid)
                    if peer_rid is not None else None)
            self._assign_peers_locked()
            members = sorted(self._ring.members())
            done_evt = self._fo_done.get(rid)
        if rep.lifecycle.state != lc.DEAD:
            rep.lifecycle.transition(lc.DEAD, reason="lost")
        if self.tel is not None:
            self.tel.emit("replica_lost", replica=rid,
                          parent=self._serve_sid, peer=peer_rid)
            self.tel.emit("failover_start", replica=rid,
                          parent=self._serve_sid, peer=peer_rid)
        if shipper is not None:
            # final catch-up: everything the dead replica fsynced before
            # its last breath reaches the copy (torn tail excluded)
            shipper.stop(final_flush=True)
        # the dead replica's engines leave the card before the peer builds
        # its own
        rep.release()
        with self._lock:
            self.last_journal = self._ship_dest(rid)
        summary = None
        if peer is not None:
            try:
                summary = peer.adopt_journal(self._ship_dest(rid))
            except (ServeError, OSError) as e:
                logger.warning("fleet failover: peer %s failed to adopt "
                               "%s's journal: %s", peer_rid, rid, e)
        rep.dead.set()
        if done_evt is not None:
            done_evt.set()
        if self.tel is not None:
            self.tel.emit(
                "failover_done", replica=rid, parent=self._serve_sid,
                peer=peer_rid, s=time.perf_counter() - t0,
                requeued=(summary or {}).get("requeued", 0),
                results=(summary or {}).get("results", 0),
            )
            self.tel.emit("ring_rebalanced", replica=rid,
                          parent=self._serve_sid, reason="leave",
                          members=",".join(members))
        self._collect_bundle(rid, "replica_failover")
        cb = self.on_failover
        if cb is not None:
            try:
                cb(rid, peer_rid)
            # netrep: allow(exception-taxonomy) — a broken respawn hook must not kill the health loop; the fleet keeps serving on the survivors
            except Exception:
                logger.warning("fleet on_failover hook failed",
                               exc_info=True)

    def _collect_bundle(self, rid: str, reason: str) -> str | None:
        """The departed replica's diagnostic bundle: the flight ring, the
        environment, the kernel libraries and the shipped journal copy's
        REDACTED tail, under ``<fleet_dir>/bundles/``. Best-effort: a
        failed collection warns and never blocks a failover or handoff."""
        base = self.config.fleet_dir or os.path.join(
            os.getcwd(), "netrep_fleet")
        from ..utils import bundle

        try:
            path = bundle.collect(
                os.path.join(base, "bundles",
                             f"netrep-bundle-{reason}-{rid}"),
                reason=reason, telemetry=self.tel,
                journal=self._ship_dest(rid),
            )
        # netrep: allow(exception-taxonomy) — bundle collection is best-effort forensics; the fleet keeps serving either way
        except Exception:
            logger.warning("fleet: bundle collection for departed "
                           "replica %s failed", rid, exc_info=True)
            return None
        logger.info("fleet: collected diagnostic bundle for %s at %s",
                    rid, path)
        return path

    def await_failover(self, rid: str,
                       timeout: float | None = None) -> bool:
        """Block until failover for ``rid`` has completed (the peer has
        adopted its journal) — what a re-routing request waits on before
        retrying under its idempotency key."""
        with self._lock:
            evt = self._fo_done.get(rid)
        if evt is None:
            return True
        return evt.wait(timeout if timeout is not None
                        else self.config.failover_wait_s)

    def kill_replica(self, rid: str) -> None:
        """Drill helper: SIGKILL for a daemon; for in-process replicas the
        fault plan does the killing — either way this triggers immediate
        detection instead of waiting a heartbeat."""
        with self._lock:
            rep = self._replicas.get(rid)
        if rep is None:
            return
        kill = getattr(rep, "kill", None)
        if kill is not None:
            kill()
        self._failover(rid)

    # -- planned departures: retire + eviction handoff ---------------------

    def ship_flush(self, rid: str) -> str | None:
        """Synchronously ship ``rid``'s journal tail and return the copy's
        path (None when the replica ships nothing) — what a freshly
        spawned replica adopts its registrations from."""
        with self._lock:
            shipper = self._shippers.get(rid)
        if shipper is None:
            return None
        shipper.flush()
        return self._ship_dest(rid)

    def _handoff(self, rid: str, *, reason: str,
                 grace_s: float | None = None) -> dict | None:
        """Planned departure — the zero-recompute twin of
        :meth:`_failover`:

        1. ring removal FIRST (no new routes land on the leaver),
        2. bounded drain (work that cannot finish inside the grace is
           journaled ``drain_requeued``),
        3. pre-ship of the journal tail,
        4. peer adoption (duplicates answer from journaled results;
           anything requeued resumes from the SHARED checkpoint
           directory at its last chunk boundary).

        Returns the handoff summary, or None when ``rid`` is not a live
        replica."""
        t0 = time.perf_counter()
        with self._lock:
            rep = self._replicas.get(rid)
            if (rep is None or rid in self._dead
                    or rid in self._draining):
                return None
            self._draining.add(rid)
            self._ring.remove(rid)
            shipper = self._shippers.pop(rid, None)
            peer_rid = self._peers.pop(rid, None)
            if peer_rid is None or peer_rid in self._dead:
                peer_rid = self._ring.route(rid)   # any survivor
            peer = (self._replicas.get(peer_rid)
                    if peer_rid is not None else None)
            self._assign_peers_locked()
            members = sorted(self._ring.members())
            done_evt = self._fo_done.get(rid)
        if rep.lifecycle.state == lc.READY:
            rep.lifecycle.transition(lc.DRAINING, reason=reason)
        if self.tel is not None:
            self.tel.emit("ring_rebalanced", replica=rid,
                          parent=self._serve_sid, reason=reason,
                          members=",".join(members))
        rep.close(drain=True,
                  timeout=(grace_s if grace_s is not None
                           else self.config.drain_timeout_s))
        if shipper is not None:
            shipper.stop(final_flush=True)
        with self._lock:
            self.last_journal = self._ship_dest(rid)
        summary = None
        if peer is not None:
            try:
                summary = peer.adopt_journal(self._ship_dest(rid))
            except (ServeError, OSError) as e:
                logger.warning("fleet handoff: peer %s failed to adopt "
                               "%s's journal: %s", peer_rid, rid, e)
        with self._lock:
            self._dead.add(rid)
            self._draining.discard(rid)
        if rep.lifecycle.state != lc.DEAD:
            rep.lifecycle.transition(lc.DEAD, reason="drained")
        rep.dead.set()
        if done_evt is not None:
            done_evt.set()
        if self.tel is not None and not members:
            self.tel.emit("scale_to_zero", replica=rid,
                          parent=self._serve_sid,
                          journal=self._ship_dest(rid))
        return {
            "replica": rid,
            "peer": peer_rid,
            "s": time.perf_counter() - t0,
            "requeued": (summary or {}).get("requeued", 0),
            "results": (summary or {}).get("results", 0),
        }

    def retire_replica(self, rid: str) -> dict | None:
        """Drain-and-retire one replica (the autoscaler's scale-down move):
        planned departure under the full drain timeout."""
        return self._handoff(rid, reason="retire")

    def evict_notice(self, rid: str, grace_s: float = 30.0) -> dict | None:
        """Eviction notice: the capacity under ``rid`` will be revoked in
        ``grace_s`` seconds. Runs the full handoff — ring removal, bounded
        drain, journal-tail pre-ship, peer adoption — BEFORE the kill, so
        a noticed eviction loses zero work and recomputes nothing. Returns
        the handoff summary (None when ``rid`` is not live)."""
        if self.tel is not None:
            self.tel.emit("evict_notice", replica=rid,
                          parent=self._serve_sid,
                          grace_s=float(grace_s))
        out = self._handoff(rid, reason="evict", grace_s=grace_s)
        if out is not None and self.tel is not None:
            self.tel.emit("evict_handoff_done", replica=rid,
                          parent=self._serve_sid, peer=out["peer"],
                          s=out["s"], requeued=out["requeued"],
                          results=out["results"])
        if out is not None:
            self._collect_bundle(rid, "replica_evicted")
        return out

    # -- routing -----------------------------------------------------------

    def _route_key(self, tenant: str, discovery: str, test) -> str:
        tests = list(test) if isinstance(test, (list, tuple)) else [test]
        with self._lock:
            parts = [
                self._digests.get((tenant, n), f"name:{tenant}:{n}")
                for n in [discovery, *tests]
            ]
        return "|".join(parts)

    def route(self, tenant: str, discovery: str, test):
        """The live replica owning this dataset pair (same pair → same
        replica → warm pooled engines), or None when the fleet is
        empty."""
        key = self._route_key(tenant, discovery, test)
        with self._lock:
            rid = self._ring.route(key)
            return self._replicas.get(rid) if rid is not None else None

    def note_digest(self, tenant: str, name: str, digest: str) -> None:
        """Record a dataset's content digest for ring routing (the wire
        coordinator captures it from a broadcast ``register``
        response)."""
        with self._lock:
            self._digests[(tenant, name)] = str(digest)

    # -- fleet-wide admission ----------------------------------------------

    def _fallback_rate_locked(self) -> float | None:
        """Per-replica rate assumption: configured, else the shared perf
        ledger's serve/run history (read once, cached) — None when nothing
        is known (fleet brownout then stays off: no guessing)."""
        if self.config.rate_pps:
            return float(self.config.rate_pps)
        if not self._ledger_rate_read:
            self._ledger_rate_read = True
            from ..utils import perfledger

            self._ledger_rate = perfledger.serve_rate()
        return self._ledger_rate

    def drain_estimate(self, extra_perms: int = 0) -> float | None:
        """AGGREGATE backlog drain estimate: queued permutations summed
        across live replicas over the summed per-replica rates — the
        fleet-wide admission signal. None when no rate is known."""
        backlog = extra_perms
        rate = 0.0
        unknown = 0
        for rep in self.live_replicas().values():
            st = rep.stats()
            backlog += int(st.get("backlog_perms", 0) or 0)
            r = st.get("rate_pps")
            if r:
                rate += float(r)
            else:
                unknown += 1
        if unknown:
            with self._lock:
                fb = self._fallback_rate_locked()
            if fb:
                rate += fb * unknown
        if rate <= 0:
            return None
        return backlog / rate

    def admit(self, extra_perms: int = 0) -> None:
        """Fleet-wide brownout gate, called before routing a new analyze:
        raises :class:`QueueFull` with the aggregate drain estimate as
        ``retry_after_s`` while browned out (the per-replica brownout
        still applies behind it)."""
        cfg = self.config
        if cfg.brownout_enter_s is None:
            return
        est = self.drain_estimate(extra_perms)
        if est is None:
            return
        exit_s = (cfg.brownout_exit_s if cfg.brownout_exit_s is not None
                  else cfg.brownout_enter_s / 2.0)
        with self._lock:
            if not self._brownout and est > cfg.brownout_enter_s:
                self._brownout = True
                if self.tel is not None:
                    self.tel.emit("serve_brownout_enter", fleet=True,
                                  est_drain_s=float(est),
                                  parent=self._serve_sid)
            elif self._brownout and est < exit_s:
                self._brownout = False
                if self.tel is not None:
                    self.tel.emit("serve_brownout_exit", fleet=True,
                                  est_drain_s=float(est),
                                  parent=self._serve_sid)
            browned = self._brownout
        if browned:
            raise QueueFull(
                f"fleet is browned out (aggregate backlog drain "
                f"{est:.1f}s); retry later",
                retry_after_s=round(est, 3),
            )

    # -- client surface ----------------------------------------------------

    def register_tenant(self, name: str, weight: int = 1) -> None:
        for rep in self.live_replicas().values():
            rep.register_tenant(name, weight)

    def register_dataset(self, tenant: str, name: str, **kw) -> str:
        """Broadcast registration (every replica may inherit any pair on
        failover/rebalance); records the content digest for ring routing.
        Returns the digest — identical on every replica."""
        digest = None
        for rep in self.live_replicas().values():
            digest = rep.register_dataset(tenant, name, **kw)
        if digest is None:
            raise ServeError("no live replicas to register on")
        with self._lock:
            self._digests[(tenant, name)] = digest
        return digest

    def register_fixture(self, tenant: str, prefix: str = "fx",
                         **kw) -> dict:
        out = None
        for rep in self.live_replicas().values():
            out = rep.register_fixture(tenant, prefix, **kw)
        if out is None:
            raise ServeError("no live replicas to register on")
        return out

    def analyze(self, tenant: str, discovery: str, test, *,
                timeout: float | None = None, **kw) -> dict:
        """Blocking analyze through the fleet: admission gate → ring route
        → replica. A replica death mid-flight waits for failover and
        re-routes under the SAME idempotency key (set here when the caller
        sent none), so the retry attaches to the adopted computation or
        answers from the shipped journal — never a second computation."""
        kw.setdefault("idempotency_key", f"f-{uuid.uuid4().hex[:16]}")
        n_perm = int(kw.get("n_perm") or 0)
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            self.admit(extra_perms=n_perm)
            rep = self.route(tenant, discovery, test)
            if rep is None:
                # scale to zero: an empty autoscaled fleet spawns on
                # demand and the request queues behind the boot
                scaler = self.autoscaler
                if scaler is not None and scaler.request_spawn():
                    if (deadline is not None
                            and time.monotonic() > deadline):
                        raise TimeoutError(
                            "request timed out waiting for a "
                            "spawn-on-demand replica"
                        )
                    time.sleep(0.05)
                    continue
                raise ServeError("fleet has no live replicas")
            left = (None if deadline is None
                    else max(0.1, deadline - time.monotonic()))
            try:
                return rep.analyze(tenant, discovery, test,
                                   timeout=left, **kw)
            except ReplicaLost:
                self.await_failover(rep.rid)
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        "request did not finish before its timeout "
                        "(failover consumed the budget)"
                    ) from None

    # -- ops surface -------------------------------------------------------

    def stats(self) -> dict:
        """Fleet-level stats: one row per replica (alive/dead, lifecycle
        state and generation, backlog, rate, packs, per-tenant counters)
        plus merged per-tenant counters and the coordinator's admission
        state — what ``top`` renders as the per-replica section."""
        with self._lock:
            reps = dict(self._replicas)
            dead = set(self._dead)
            brownout = self._brownout
            members = sorted(self._ring.members())
        rows = {}
        merged: dict[str, dict] = {}
        inflight = packs = 0
        for rid in sorted(reps):
            cycle = reps[rid].lifecycle
            if rid in dead:
                rows[rid] = {"alive": False, "state": cycle.state,
                             "gen": cycle.generation}
                continue
            st = reps[rid].stats()
            tenants = st.get("tenants", {})
            rows[rid] = {
                "alive": True,
                "state": cycle.state,
                "gen": cycle.generation,
                "idle_s": st.get("idle_s"),
                "pid": getattr(getattr(reps[rid], "proc", None), "pid",
                               None),
                "backlog_perms": st.get("backlog_perms", 0),
                "rate_pps": st.get("rate_pps"),
                "utilisation": st.get("utilisation"),
                "inflight": st.get("inflight", 0),
                "packs": st.get("packs", 0),
                "brownout": st.get("brownout", False),
                "queue_depth": sum(t.get("queue_depth", 0)
                                   for t in tenants.values()),
                "done": sum(t.get("done", 0) for t in tenants.values()),
            }
            inflight += int(st.get("inflight", 0) or 0)
            packs += int(st.get("packs", 0) or 0)
            for tn, t in tenants.items():
                m = merged.setdefault(tn, {
                    "weight": t.get("weight", 1), "queue_depth": 0,
                    "received": 0, "done": 0, "failed": 0,
                    "rejected": 0, "expired": 0, "deduped": 0,
                    "cost": {"device_s": 0.0, "perms": 0,
                             "bytes_to_host": 0},
                    "burn_rate": 0.0,
                })
                for k in ("queue_depth", "received", "done", "failed",
                          "rejected", "expired", "deduped"):
                    m[k] += int(t.get(k, 0) or 0)
                c = t.get("cost") or {}
                m["cost"]["device_s"] += float(c.get("device_s", 0.0))
                m["cost"]["perms"] += int(c.get("perms", 0) or 0)
                m["cost"]["bytes_to_host"] += int(
                    c.get("bytes_to_host", 0) or 0)
                m["burn_rate"] = max(m["burn_rate"],
                                     float(t.get("burn_rate", 0.0)))
        return {
            "fleet": True,
            "replicas": rows,
            "ring": members,
            "tenants": merged,
            "brownout": brownout,
            "accepting": not self._stop.is_set(),
            "inflight": inflight,
            "packs": packs,
            "uptime_s": time.monotonic() - self._started_m,
        }

    def metrics_text(self) -> str:
        """Concatenated per-replica Prometheus expositions, each under a
        replica-identifying comment header."""
        return "".join(
            f"# fleet replica {rid}\n" + rep.metrics_text()
            for rid, rep in sorted(self.live_replicas().items())
        )


# ---------------------------------------------------------------------------
# autoscaling
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AutoscaleConfig:
    """Autoscaler knobs (the JAX package's). The scaling signal is the
    coordinator's AGGREGATE backlog-drain estimate, with hysteresis: scale
    up above ``scale_up_drain_s``, allow scale-down only below
    ``scale_up_exit_s`` (default half) — plus a cooldown between actions
    and a per-replica idle requirement, so the loop never flaps."""

    #: spawn a replica when the aggregate drain estimate exceeds this
    scale_up_drain_s: float = 10.0
    #: hysteresis exit: retirement is only considered below this (None =
    #: half of ``scale_up_drain_s``)
    scale_up_exit_s: float | None = None
    #: retire a replica after it has been idle (no inflight work, no
    #: backlog) this long — measured on the autoscaler's own clock
    scale_down_idle_s: float = 30.0
    #: fleet-size bounds; ``min_replicas=0`` enables scale-to-zero
    min_replicas: int = 0
    max_replicas: int = 4
    #: minimum spacing between scaling actions (either direction)
    cooldown_s: float = 5.0
    #: control-loop poll interval of the threaded loop (tests drive
    #: :meth:`Autoscaler.tick` directly under an injected clock)
    tick_s: float = 0.25


class Autoscaler:
    """The closed loop over a fleet: grow it when the aggregate
    backlog-drain estimate says the queue is outrunning capacity,
    drain-and-retire idle replicas (:meth:`FleetCoordinator.
    retire_replica`), and — with ``min_replicas=0`` — scale to zero, where
    the journal is the fleet's state: a submission against the empty fleet
    spawns on demand and queues behind the boot.

    ``spawn(index) -> replica`` is the capacity source
    (:func:`inprocess_spawner`). A freshly spawned replica adopts a live
    peer's shipped journal copy (datasets only) — or, from zero, the LAST
    drained replica's full copy — before it enters the ring.

    Deterministic under test: ``clock`` is injectable and :meth:`tick`
    runs one decision pass synchronously (``start=False``: no thread)."""

    def __init__(self, coord: FleetCoordinator, spawn,
                 config: AutoscaleConfig | None = None, *,
                 clock=time.monotonic, start: bool = True):
        self.coord = coord
        self._spawn_fn = spawn
        self.config = config or AutoscaleConfig()
        self._clock = clock
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_action: float | None = None
        self._spawning = False
        #: clock time each replica was last seen busy (first sight counts
        #: as busy — a replica must prove an idle PERIOD)
        self._last_busy: dict[str, float] = {}
        # the next spawn index clears EVERY replica id the coordinator has
        # ever seen (dead ones included): a reused rid would collide in
        # the ring, the ship directory and the telemetry fold
        seen = [int(rid[1:].split(".")[0])
                for rid in coord.stats().get("replicas", {})
                if rid.startswith("r")
                and rid[1:].split(".")[0].isdigit()]
        self._next_index = max(seen) + 1 if seen else 0
        coord.autoscaler = self
        if start:
            self.start()

    # -- loop lifecycle ----------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._loop, name="netrep-fleet-autoscale",
                daemon=True,
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=30.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.config.tick_s):
            try:
                self.tick()
            except (ServeError, OSError):
                logger.warning("autoscaler tick failed", exc_info=True)

    # -- the control loop --------------------------------------------------

    def _cooldown_over(self, now: float) -> bool:
        return (self._last_action is None
                or now - self._last_action >= self.config.cooldown_s)

    def tick(self, now: float | None = None) -> str | None:
        """One decision pass: returns ``"up"``, ``"down"``, or None.
        Deterministic given the fleet's stats and the clock."""
        cfg = self.config
        now = self._clock() if now is None else float(now)
        with self._lock:
            if self._spawning:
                return None
            cooldown_ok = self._cooldown_over(now)
        live = self.coord.live_replicas()
        # idle bookkeeping on the autoscaler's own clock: a replica is
        # busy while it has inflight work or queued backlog
        for rid, rep in live.items():
            st = rep.stats()
            busy = bool(st.get("inflight", 0)
                        or st.get("backlog_perms", 0))
            if busy or rid not in self._last_busy:
                self._last_busy[rid] = now
        for rid in list(self._last_busy):
            if rid not in live:
                del self._last_busy[rid]
        if not cooldown_ok:
            return None
        est = self.coord.drain_estimate()
        # below the floor (an eviction can sink the fleet under it):
        # restore capacity regardless of backlog
        if len(live) < cfg.min_replicas:
            if self._do_spawn(reason="min_replicas", est=est):
                return "up"
            return None
        if (est is not None and est > cfg.scale_up_drain_s
                and len(live) < cfg.max_replicas):
            if self._do_spawn(reason="backlog", est=est):
                return "up"
            return None
        exit_s = (cfg.scale_up_exit_s if cfg.scale_up_exit_s is not None
                  else cfg.scale_up_drain_s / 2.0)
        if (len(live) > cfg.min_replicas
                and (est is None or est < exit_s)):
            idle = [rid for rid in live
                    if now - self._last_busy.get(rid, now)
                    >= cfg.scale_down_idle_s]
            if idle:
                rid = sorted(idle)[-1]   # newest id retires first
                if self.coord.tel is not None:
                    self.coord.tel.emit(
                        "autoscale_down", replica=rid,
                        parent=self.coord._serve_sid,
                        idle_s=now - self._last_busy.get(rid, now),
                        replicas=len(live) - 1,
                    )
                self.coord.retire_replica(rid)
                with self._lock:
                    self._last_action = now
                return "down"
        return None

    # -- spawning ----------------------------------------------------------

    def request_spawn(self) -> bool:
        """Spawn-on-demand entry (the coordinator calls this when a request
        finds the fleet empty): True means a replica is coming (spawned
        here, already mid-spawn, or already joined); False means the
        autoscaler cannot add capacity (``max_replicas`` is 0)."""
        if self.coord.live_replicas():
            return True
        if self.config.max_replicas < 1:
            return False
        with self._lock:
            in_flight = self._spawning
        if in_flight:
            return True
        self._do_spawn(reason="empty_fleet", event="spawn_on_demand")
        return True

    def _do_spawn(self, *, reason: str, est: float | None = None,
                  event: str = "autoscale_up") -> bool:
        with self._lock:
            if self._spawning:
                return False
            self._spawning = True
            idx = self._next_index
            self._next_index += 1
        try:
            rep = self._spawn_fn(idx)
            # seed the newcomer BEFORE it enters the ring: a live peer's
            # shipped copy replays registrations (datasets only — its
            # pending work is its own); from zero, the last drained
            # replica's copy replays EVERYTHING, including requests the
            # drain journaled as requeued
            live = sorted(self.coord.live_replicas())
            src = (self.coord.ship_flush(live[0]) if live
                   else self.coord.last_journal)
            if src:
                try:
                    rep.adopt_journal(src, datasets_only=bool(live))
                except (ServeError, OSError) as e:
                    logger.warning("autoscale spawn: %s failed to adopt "
                                   "%s: %s", rep.rid, src, e)
            self.coord.join(rep)
            if self.coord.tel is not None:
                data = {"replica": rep.rid, "reason": reason,
                        "replicas": len(self.coord.live_replicas())}
                if est is not None:
                    data["est_drain_s"] = float(est)
                self.coord.tel.emit(event, parent=self.coord._serve_sid,
                                    **data)
            return True
        finally:
            with self._lock:
                self._spawning = False
                self._last_action = self._clock()


# ---------------------------------------------------------------------------
# in-process fleet construction
# ---------------------------------------------------------------------------


def _make_inprocess_replica(i: int, fleet_dir: str, make_config=None,
                            start_servers: bool = True) -> InProcessReplica:
    """One in-process replica in the fleet layout (``r<i>/journal.jsonl``
    + the SHARED ``ckpt/``) — the construction :func:`build_inprocess_fleet`
    and :func:`inprocess_spawner` share."""
    ckpt_dir = os.path.join(fleet_dir, "ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    rid = f"r{i}"
    rdir = os.path.join(fleet_dir, rid)
    os.makedirs(rdir, exist_ok=True)
    jpath = os.path.join(rdir, "journal.jsonl")
    if make_config is not None:
        cfg = make_config(rid, jpath, ckpt_dir)
    else:
        cfg = ServeConfig(journal=jpath, checkpoint_dir=ckpt_dir,
                          fleet_label=rid)
    return InProcessReplica(
        rid, PreservationServer(cfg, start=start_servers)
    )


def inprocess_spawner(fleet_dir: str, *, make_config=None,
                      start_servers: bool = True):
    """The :class:`Autoscaler` ``spawn`` callable for in-process fleets:
    ``spawn(index)`` boots ``r<index>`` into the same fleet layout (same
    shared checkpoint directory, same ``make_config`` knobs) the static
    replicas use."""
    def spawn(index: int) -> InProcessReplica:
        return _make_inprocess_replica(index, fleet_dir, make_config,
                                       start_servers=start_servers)
    return spawn


def build_inprocess_fleet(
    n: int, fleet_dir: str, *, make_config=None,
    fleet_config: FleetConfig | None = None, start: bool = True,
    start_servers: bool = True,
) -> FleetCoordinator:
    """N in-process replicas under one coordinator.

    Layout under ``fleet_dir``: ``r<i>/journal.jsonl`` per replica,
    ``ship/`` for the shipped copies, and ONE SHARED ``ckpt/`` — pack
    checkpoint paths are keyed on member identity and engine config (not
    on the replica), so the peer adopting a dead replica's requests finds
    its mid-pack checkpoints where the dead replica left them and resumes
    from the last chunk boundary.

    ``make_config(rid, journal_path, ckpt_dir) -> ServeConfig`` injects
    per-replica knobs (``device="cpu"`` runs the fleet on the CPU); the
    default is a journaled config with ``fleet_label=rid`` on the card
    (``RuntimeError`` without one)."""
    os.makedirs(os.path.join(fleet_dir, "ship"), exist_ok=True)
    os.makedirs(os.path.join(fleet_dir, "ckpt"), exist_ok=True)
    if fleet_config is None:
        fleet_config = FleetConfig()
    if fleet_config.fleet_dir is None:
        fleet_config = dataclasses.replace(fleet_config,
                                           fleet_dir=fleet_dir)
    replicas = [
        _make_inprocess_replica(i, fleet_dir, make_config,
                                start_servers=start_servers)
        for i in range(int(n))
    ]
    return FleetCoordinator(replicas, fleet_config, start=start)


def dispatch_fleet_op(coord: FleetCoordinator, op: dict,
                      stop: threading.Event,
                      route_mode: str = "proxy") -> dict:
    """Execute one wire op against the coordinator. Registrations
    broadcast (the digest noted for ring routing); ``analyze`` routes by
    the ring and PROXIES the op verbatim to the home replica's
    ``forward`` (idempotency keys and trace ids pass through unchanged),
    re-routing under the same key when the replica is lost — or, under
    ``route_mode='redirect'``, answers with a ``redirect`` naming a daemon
    replica's socket, so the client re-sends the same op there directly;
    ``evict_notice`` runs the handoff. Never raises."""
    from .server import _malformed

    if not isinstance(op, dict):
        return _malformed(coord, f"op must be a JSON object, "
                                 f"got {type(op).__name__}")
    try:
        kind = op.get("op")
        if kind == "ping":
            return {"ok": True, "pong": True, "fleet": True,
                    "replicas": sorted(coord.live_replicas())}
        if kind == "stats":
            return {"ok": True, "stats": coord.stats()}
        if kind == "metrics":
            return {"ok": True, "text": coord.metrics_text()}
        if kind == "shutdown":
            stop.set()
            return {"ok": True, "draining": True}
        if kind == "evict_notice":
            # noticed preemption: handoff, not failover — the reply
            # carries the handoff receipt (peer, seconds, requeued/result
            # counts)
            rid = str(op.get("replica") or "")
            if rid not in coord.live_replicas():
                return {"ok": False,
                        "error": f"no live replica {rid!r}"}
            grace = float(op.get("grace_s") or 30.0)
            summary = coord.evict_notice(rid, grace_s=grace)
            if summary is None:
                return {"ok": False,
                        "error": f"replica {rid!r} left before the "
                                 f"notice landed"}
            return {"ok": True, "evicted": rid, **summary}
        if kind in ("register", "register_fixture"):
            reps = [rep for _rid, rep in sorted(coord.live_replicas().items())]
            if not reps:
                return {"ok": False, "error": "no live replicas"}
            if all(getattr(r, "socket_path", None) for r in reps):
                # daemons are processes of their own: they register at
                # once (a 20,000-gene fixture takes each tens of seconds)
                resps = [None] * len(reps)

                def one(i):
                    try:
                        resps[i] = reps[i].forward(op)
                    except (OSError, ValueError) as e:
                        resps[i] = {"ok": False, "error": f"replica "
                                    f"{reps[i].rid}: {type(e).__name__}: "
                                    f"{e}"}

                threads = [threading.Thread(target=one, args=(i,))
                           for i in range(len(reps))]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
            else:
                resps = []
                for rep in reps:
                    resps.append(rep.forward(op))
                    if not resps[-1].get("ok", False):
                        break
            resp = next((r for r in resps if not r.get("ok", False)),
                        resps[-1])
            if not resp.get("ok", False):
                return resp
            if kind == "register" and resp.get("digest"):
                coord.note_digest(str(op.get("tenant")),
                                  str(op.get("name")),
                                  str(resp["digest"]))
            return resp
        if kind == "analyze":
            op.setdefault("idempotency_key",
                          f"f-{uuid.uuid4().hex[:16]}")
            try:
                coord.admit(extra_perms=int(op.get("n_perm") or 0))
            except QueueFull as e:
                resp = {"ok": False, "error": f"QueueFull: {e}",
                        "retryable": True}
                if e.retry_after_s is not None:
                    resp["retry_after_s"] = float(e.retry_after_s)
                return resp
            for _hop in range(8):   # bounded: re-routes per failover
                rep = coord.route(str(op.get("tenant")),
                                  str(op.get("discovery")),
                                  op.get("test"))
                if rep is None:
                    return {"ok": False, "error": "fleet has no live "
                                                  "replicas"}
                if (route_mode == "redirect"
                        and getattr(rep, "socket_path", None)):
                    # data-plane redirect: the client re-sends the SAME op
                    # (same key, same trace) to the home replica, and the
                    # coordinator stays off the hot path
                    return {"ok": False, "retryable": True,
                            "redirect": rep.socket_path}
                try:
                    resp = rep.forward(op)
                except (OSError, ValueError):
                    coord.await_failover(rep.rid)
                    continue
                if (not resp.get("ok", False)
                        and "requeued-on-restart"
                        in str(resp.get("error", ""))):
                    # the home replica drained away with this request
                    # still queued: the journaled record migrates with the
                    # handoff — wait for the peer to adopt it, then retry
                    # the SAME idempotency key there
                    coord.await_failover(rep.rid)
                    continue
                return resp
            return {"ok": False, "retryable": True,
                    "error": "request kept losing its replica; retry",
                    "retry_after_s": 1.0}
        return _malformed(coord, f"unknown op {kind!r}")
    except (ServeError, TimeoutError, KeyError, TypeError,
            ValueError) as e:
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}
    # netrep: allow(exception-taxonomy) — wire boundary, as server.dispatch_op: one failed op becomes that client's error line, the coordinator keeps serving
    except Exception as e:
        return {"ok": False,
                "error": f"internal error: {type(e).__name__}: {e}"}


# ---------------------------------------------------------------------------
# daemon fleet (`python -m netrep_tpu_torch serve --fleet N`)
# ---------------------------------------------------------------------------

#: the checkout's root, put on a daemon's ``PYTHONPATH`` so ``python -m
#: netrep_tpu_torch`` finds the package from any directory
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def daemon_env(**extra) -> dict:
    """The environment of a daemon this process starts: its own, the
    checkout's root on ``PYTHONPATH``, the kernel-library store named (so
    every generation reads the same one), then ``extra``."""
    from ..utils import aot

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    env[aot.STORE_ENV] = str(aot.store_dir())
    env.update(extra)
    return env


def spawn_replica_daemon(rid: str, fleet_dir: str, args, *,
                         generation: int = 0,
                         env_extra: dict | None = None) -> DaemonReplica:
    """Boot one replica daemon on its own socket, journaling into the
    fleet layout with the SHARED checkpoint directory, on the
    coordinator's ``--device`` (the card unless ``cpu``), with
    ``--fleet-label`` so it builds or loads every kernel library at boot.
    Respawns bump ``generation`` (``serve.g1.sock``, ``journal.g1.jsonl``)
    so a fresh journal never replays work the peer already adopted. The
    daemon's standard output (its ``ready`` line) goes to
    ``serve[.gN].out`` beside its journal, its errors to ``serve[.gN].err``.
    Every generation reads the same kernel-library store."""
    import subprocess
    import sys

    rdir = os.path.join(fleet_dir, rid.split(".", 1)[0])
    os.makedirs(rdir, exist_ok=True)
    suffix = f".g{generation}" if generation else ""
    sock = os.path.join(rdir, f"serve{suffix}.sock")
    jpath = os.path.join(rdir, f"journal{suffix}.jsonl")
    cmd = [
        sys.executable, "-m", "netrep_tpu_torch", "serve",
        "--socket", sock, "--journal", jpath,
        "--checkpoint-dir", os.path.join(fleet_dir, "ckpt"),
        "--chunk", str(args.chunk),
        "--checkpoint-every", str(getattr(args, "checkpoint_every", 4096)),
        "--drain-timeout", str(args.drain_timeout),
        "--telemetry", os.path.join(rdir, f"tel{suffix}.jsonl"),
        "--fleet-label", rid,
    ]
    if getattr(args, "device", None):
        cmd += ["--device", str(args.device)]
    if args.n_perm:
        cmd += ["--n-perm", str(args.n_perm)]
    if args.brownout_enter_s is not None:
        cmd += ["--brownout-enter-s", str(args.brownout_enter_s)]
    # a replica never inherits the coordinator's fault plan or its eviction
    # drill: both address the FLEET, not the child process
    env = daemon_env(**(env_extra or {}))
    for k in ("NETREP_FAULT_PLAN", "NETREP_FLEET_EVICT"):
        if k not in (env_extra or {}):
            env.pop(k, None)
    out_path = os.path.join(rdir, f"serve{suffix}.out")
    with open(out_path, "w") as out, \
            open(os.path.join(rdir, f"serve{suffix}.err"), "w") as err:
        proc = subprocess.Popen(cmd, stdout=out, stderr=err, env=env)
    return DaemonReplica(rid, sock, jpath, proc=proc, generation=generation,
                         out_path=out_path)


def _wait_socket(rep: DaemonReplica, budget_s: float = 180.0) -> bool:
    deadline = time.monotonic() + budget_s
    while not os.path.exists(rep.socket_path):
        if (time.monotonic() > deadline
                or (rep.proc is not None and rep.proc.poll() is not None)):
            return False
        time.sleep(0.05)
    return True


def fleet_daemon(args) -> int:
    """The CLI's ``serve --fleet N --socket PATH``: spawn N replica
    daemons, run the coordinator on the main socket, respawn a failed
    replica under a new generation (the peer already adopted the old
    journal) unless ``--no-respawn``; ``--autoscale`` runs the
    :class:`Autoscaler` over daemon spawns, and ``NETREP_FLEET_EVICT=
    rid[:grace[:after]]`` fires one noticed eviction (a drill). The ready
    line names each replica's socket and carries each one's boot split."""
    import signal
    import sys

    if not args.socket:
        print("serve --fleet needs --socket PATH (the coordinator "
              "socket)", file=sys.stderr)
        return 2
    if args.no_journal:
        print("serve --fleet requires journaling (the failover story "
              "IS the journal); drop --no-journal", file=sys.stderr)
        return 2
    fleet_dir = args.fleet_dir or (args.socket + ".fleet")
    os.makedirs(os.path.join(fleet_dir, "ckpt"), exist_ok=True)
    os.makedirs(os.path.join(fleet_dir, "ship"), exist_ok=True)

    # the injected fault plan (drills) reaches EXACTLY ONE replica: the
    # coordinator and the other replicas run clean
    plan = os.environ.get("NETREP_FAULT_PLAN")
    plan_replica = os.environ.get("NETREP_FLEET_FAULT_REPLICA")
    replicas = []
    for i in range(int(args.fleet)):
        extra = {}
        if plan and plan_replica is not None and str(i) == plan_replica:
            extra["NETREP_FAULT_PLAN"] = plan
        replicas.append(spawn_replica_daemon(f"r{i}", fleet_dir, args,
                                             env_extra=extra))
    for rep in replicas:
        if not _wait_socket(rep):
            print(f"fleet replica {rep.rid} never opened its socket",
                  file=sys.stderr)
            for r in replicas:
                r.close(drain=False, timeout=5)
            return 1

    coord = FleetCoordinator(replicas, FleetConfig(
        heartbeat_s=args.heartbeat_s,
        ship_interval_s=args.ship_interval_s,
        fleet_dir=fleet_dir,
        telemetry=args.telemetry,
        brownout_enter_s=args.fleet_brownout_enter_s,
        rate_pps=args.brownout_rate,
        drain_timeout_s=args.drain_timeout,
    ))
    generations = {rep.rid: 0 for rep in replicas}

    if not args.no_respawn:
        def respawn(rid, _peer):
            base = rid.split(".", 1)[0]
            generations[base] = generations.get(base, 0) + 1
            fresh = spawn_replica_daemon(
                f"{base}.g{generations[base]}",   # r0 -> r0.g1, r0.g2 ...
                fleet_dir, args, generation=generations[base],
            )
            if not _wait_socket(fresh, budget_s=120.0):
                logger.warning("fleet respawn of %s never came up", rid)
                return
            # the newcomer adopts the registrations (datasets only) from a
            # live peer's shipped journal before it enters the ring, as an
            # autoscaled spawn does: a pair routed to it finds its datasets
            live = sorted(coord.live_replicas())
            src = coord.ship_flush(live[0]) if live else None
            if src:
                try:
                    fresh.adopt_journal(src, datasets_only=True)
                except (ServeError, OSError) as e:
                    logger.warning("fleet respawn: %s failed to adopt %s: "
                                   "%s", fresh.rid, src, e)
            coord.join(fresh)

        coord.on_failover = respawn

    if getattr(args, "autoscale", False):
        def spawn_daemon(index: int):
            rid = f"r{index}"
            generations.setdefault(rid, 0)
            fresh = spawn_replica_daemon(rid, fleet_dir, args)
            if not _wait_socket(fresh, budget_s=120.0):
                fresh.close(drain=False, timeout=5)
                raise ServeError(
                    f"autoscale spawn of {rid} never opened its socket")
            return fresh

        Autoscaler(coord, spawn_daemon, AutoscaleConfig(
            scale_up_drain_s=float(args.scale_up_drain_s or 10.0),
            scale_down_idle_s=float(args.scale_down_idle_s or 30.0),
            min_replicas=int(args.autoscale_min or 0),
            max_replicas=int(args.autoscale_max or max(4, int(args.fleet))),
        ))

    stop = threading.Event()

    # the eviction drill: NETREP_FLEET_EVICT=rid[:grace[:after]] fires ONE
    # noticed eviction against the live fleet; the drill thread is loud,
    # never fatal, and the daemon keeps serving either way
    evict_spec = os.environ.get("NETREP_FLEET_EVICT")
    if evict_spec:
        def _evict_drill():
            try:
                parts = evict_spec.split(":")
                rid = parts[0]
                grace = (float(parts[1])
                         if len(parts) > 1 and parts[1] else 30.0)
                after = (float(parts[2])
                         if len(parts) > 2 and parts[2] else 1.0)
            except ValueError:
                logger.warning("bad NETREP_FLEET_EVICT spec %r", evict_spec)
                return
            if stop.wait(after):
                return
            try:
                coord.evict_notice(rid, grace_s=grace)
            except (ServeError, OSError):
                logger.warning("eviction drill on %s failed", rid,
                               exc_info=True)

        threading.Thread(target=_evict_drill,
                         name="netrep-fleet-evict-drill",
                         daemon=True).start()

    def _drain_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _drain_signal)
    signal.signal(signal.SIGINT, _drain_signal)

    from .server import read_op_line

    path = args.socket
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass
    listener = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
    listener.bind(path)
    listener.listen(64)
    listener.settimeout(0.25)
    print(json.dumps({
        "serve": "ready", "fleet": int(args.fleet), "socket": path,
        "pid": os.getpid(), "fleet_dir": fleet_dir,
        "replicas": {r.rid: r.socket_path for r in replicas},
        "boot": {r.rid: {"spawned_t": r.spawned_t,
                         **((r.ready_line() or {}).get("boot") or {})}
                 for r in replicas},
    }), flush=True)

    def handle(conn):
        with conn:
            rfile = conn.makefile("r", encoding="utf-8")
            while True:
                op, resp = read_op_line(rfile, coord)
                if op is None and resp is None:
                    return
                if resp is not None and resp.get("empty"):
                    continue
                if resp is None:
                    resp = dispatch_fleet_op(coord, op, stop,
                                             route_mode=args.fleet_route)
                    if op.get("op") == "stats" and resp.get("ok"):
                        # the coordinator only routes and ships journals:
                        # it holds no CUDA context of its own
                        import torch

                        resp["stats"]["coordinator"] = {
                            "pid": os.getpid(),
                            "cuda_initialized": torch.cuda.is_initialized()}
                try:
                    conn.sendall((json.dumps(resp) + "\n").encode("utf-8"))
                except OSError:
                    return
                if stop.is_set():
                    return

    try:
        while not stop.is_set():
            try:
                conn, _ = listener.accept()
            except _socket.timeout:
                continue
            threading.Thread(target=handle, args=(conn,),
                             daemon=True).start()
    finally:
        listener.close()
        try:
            os.unlink(path)
        except OSError:
            pass

    coord.close(drain=True)
    print(json.dumps({"serve": "fleet_drained",
                      "replicas": sorted(generations)}), flush=True)
    return 0

"""Durable write-ahead request journal of the serving tier.

The port of ``netrep_tpu/serve/journal.py`` (host code, copied; the line
format is the JAX package's, so a journal written by either package's
server replays in the other's). The server appends one fsynced JSON line
per state transition, in the crash-safe style of
:mod:`netrep_tpu_torch.utils.telemetry` (append-only JSONL, a crash loses
at most the in-flight line, torn final lines are tolerated on read):

- ``accepted`` — written and **fsynced before the request is admitted**
  to the queue: tenant, dataset names + content digests, the full
  analyze params, the seed, the client-supplied **idempotency key**
  (auto-assigned when the client sends none), and the request's **trace
  context** (``trace={"trace": <id>, "parent": <span>}``), so a recovering
  boot re-queues the request under the SAME trace id. An accepted record
  with no matching terminal record is, by definition, work the server
  still owes.
- ``done`` / ``failed`` — the terminal record: the result digest and the
  full wire-encoded result (``done``), or the error string (``failed``).
  A ``done`` record is what a duplicate submission with the same
  idempotency key is answered from after a restart — no recompute.
- ``tenant`` / ``dataset`` — registrations, so a recovering boot can
  rebuild the server's dataset references without the clients
  re-uploading. Fixture registrations journal their *parameters* (cheap,
  re-derivable); inline registrations journal the encoded matrices (the
  wire payload).
- ``drain_requeued`` — informational: a bounded drain ran out of time
  and these accepted-but-unfinished keys exit the process as journaled
  work, picked up by the next recovering boot.

Recovery (:func:`scan` + ``PreservationServer`` replay) is deterministic:
tenants and datasets re-register in journal order, completed results are
loaded into the idempotency map, and every accepted-but-not-terminal
request re-queues in original ``seq`` order — combined with the engine's
checkpoints and the packer's per-request identities, a crash mid-pack
followed by a recovering boot yields the results of an uninterrupted
server bit for bit.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time

logger = logging.getLogger("netrep_tpu_torch")

#: journal line format version — every record carries it as ``jv`` (the
#: discriminator that lets a journal share parsers with telemetry JSONL)
JOURNAL_VERSION = 1

#: record kinds with a terminal meaning for an accepted request
TERMINAL_KINDS = ("done", "failed")


def _json_default(v):
    # numpy scalars/arrays ride journal records as plain JSON, same
    # tolerance rule as the telemetry sink
    if hasattr(v, "item") and not hasattr(v, "__len__"):
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    return str(v)


def result_digest(result: dict) -> str:
    """Stable digest of a (wire-encoded) result payload — the ``done``
    record's cheap identity, letting the recovery drill assert
    "re-served == originally served" without diffing full arrays."""
    h = hashlib.blake2b(digest_size=8)
    h.update(json.dumps(result, sort_keys=True,
                        default=_json_default).encode())
    return h.hexdigest()


class RequestJournal:
    """Append-only fsynced journal writer.

    Unlike the telemetry sink (flush-only — losing a trailing event is
    acceptable), ``accepted`` records are the server's promise to the
    client, so every append is ``flush`` + ``os.fsync``: when ``submit``
    returns, the request survives a ``SIGKILL``. Thread-safe (the
    scheduler appends under its own lock, the transports may not).
    A dead sink (full disk, revoked path) raises — accepting work that
    cannot be journaled would silently void the durability contract.
    """

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        self._fh = open(self.path, "a", encoding="utf-8")

    def append(self, kind: str, **fields) -> dict:
        """Append one fsynced record; returns it."""
        rec = {"jv": JOURNAL_VERSION, "t": time.time(),
               "kind": str(kind), **fields}
        line = json.dumps(rec, default=_json_default) + "\n"
        with self._lock:
            if self._fh is None:
                raise OSError(f"journal {self.path!r} is closed")
            self._fh.write(line)
            self._fh.flush()
            os.fsync(self._fh.fileno())
        return rec

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


def read_records(path: str):
    """Stream the journal's records, skipping anything that is not a
    schema-matching line — in particular the torn final line a crash mid-
    append leaves behind (same tolerance as the telemetry reader)."""
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn/corrupt line — tolerated by design
            if (isinstance(rec, dict) and rec.get("jv") == JOURNAL_VERSION
                    and isinstance(rec.get("kind"), str)):
                yield rec


def scan(path: str) -> dict:
    """Fold a journal into the recovery state the server replays:

    - ``tenants``: ``{name: weight}`` in first-seen order;
    - ``datasets``: the dataset/fixture registration records, in order;
    - ``results``: ``{idempotency_key: done record}`` — completed work a
      duplicate submission is answered from without recomputing;
    - ``failed``: ``{idempotency_key: failed record}`` — terminal, never
      re-queued (a deadline miss must not resurrect on restart);
    - ``pending``: accepted records with **no terminal record**, in
      original ``seq`` order — the work the restarted server re-queues.
    """
    tenants: dict[str, int] = {}
    datasets: list[dict] = []
    accepted: dict[str, dict] = {}
    results: dict[str, dict] = {}
    failed: dict[str, dict] = {}
    drain_requeued = 0
    for rec in read_records(path):
        kind = rec["kind"]
        if kind == "tenant":
            tenants[str(rec["tenant"])] = int(rec.get("weight", 1))
        elif kind == "dataset":
            tenants.setdefault(str(rec["tenant"]), 1)
            datasets.append(rec)
        elif kind == "accepted":
            key = str(rec.get("key"))
            accepted[key] = rec
        elif kind == "done":
            results[str(rec.get("key"))] = rec
        elif kind == "failed":
            failed[str(rec.get("key"))] = rec
        elif kind == "drain_requeued":
            drain_requeued += len(rec.get("keys", []))
    pending = sorted(
        (rec for key, rec in accepted.items()
         if key not in results and key not in failed),
        key=lambda r: int(r.get("seq", 0)),
    )
    return {
        "tenants": tenants,
        "datasets": datasets,
        "accepted": accepted,
        "results": results,
        "failed": failed,
        "pending": pending,
        "n_accepted": len(accepted),
        "n_drain_requeued": drain_requeued,
    }


class JournalShipper:
    """Continuous journal replication to a designated peer (the serving
    fleet's journal shipping): a daemon thread tails the source journal and
    appends every newly-fsynced COMPLETE line to the peer's copy
    (``dest_path``), fsyncing the copy before advancing the acked
    offset — so the shipped copy is itself a valid journal a failover
    replays with the ordinary ``scan()``/recovery machinery.

    Protocol details the fleet contract depends on:

    - **segment tailing with acked offsets**: each pass reads from the
      last acked byte offset to EOF and ships only up to the last
      newline — a torn in-flight line (the crash signature the reader
      already tolerates) is left for the next pass, so the copy never
      contains a record the source had not durably finished;
    - **ack = fsynced at the peer**: the offset only advances after the
      copy's ``fsync`` returns, and it is persisted to a sidecar
      (``<dest>.offset``) so shipping resumes — never re-ships, never
      skips — across a shipper (or coordinator) restart;
    - **telemetry**: each pass that moves data emits ``journal_shipped``
      (replica, records, bytes, offset) on the coordinator's bus — the
      per-replica section of ``telemetry``/``top`` folds these.

    A missing source file (replica not booted yet) is simply "nothing to
    ship". The thread is owned by its caller (the fleet coordinator,
    :mod:`~netrep_tpu_torch.serve.fleet`); ``flush()`` is the synchronous
    one-pass entry a failover path (and tests) call directly."""

    def __init__(self, src_path: str, dest_path: str, *,
                 interval_s: float = 0.2, replica: str | None = None,
                 telemetry=None):
        self.src_path = os.fspath(src_path)
        self.dest_path = os.fspath(dest_path)
        self.interval_s = float(interval_s)
        self.replica = replica
        self.tel = telemetry
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        d = os.path.dirname(os.path.abspath(self.dest_path))
        os.makedirs(d, exist_ok=True)
        self._offset_path = self.dest_path + ".offset"
        self._offset = self._load_offset()

    def _load_offset(self) -> int:
        try:
            with open(self._offset_path, encoding="utf-8") as f:
                return max(0, int(f.read().strip() or 0))
        except (OSError, ValueError):
            return 0

    @property
    def acked_offset(self) -> int:
        with self._lock:
            return self._offset

    def flush(self) -> int:
        """One synchronous ship pass; returns the bytes moved. Reads the
        source from the acked offset, ships complete lines only, fsyncs
        the copy, then persists the new offset (crash between fsync and
        offset write re-ships — ``scan()`` folds duplicate records to the
        same state, so re-shipping is safe; skipping would not be)."""
        with self._lock:
            return self._ship_locked()

    def _ship_locked(self) -> int:
        try:
            with open(self.src_path, "rb") as src:
                src.seek(self._offset)
                chunk = src.read()
        except OSError:
            return 0      # source not there yet / unreadable: next pass
        if not chunk:
            return 0
        cut = chunk.rfind(b"\n")
        if cut < 0:
            return 0      # only a torn in-flight line so far
        chunk = chunk[: cut + 1]
        try:
            with open(self.dest_path, "ab") as dst:
                dst.write(chunk)
                dst.flush()
                os.fsync(dst.fileno())
            self._offset += len(chunk)
            with open(self._offset_path, "w", encoding="utf-8") as f:
                f.write(str(self._offset))
        except OSError as e:
            logger.warning("journal shipper %s -> %s failed: %s",
                           self.src_path, self.dest_path, e)
            return 0
        if self.tel is not None:
            self.tel.emit(
                "journal_shipped", replica=self.replica,
                records=chunk.count(b"\n"), bytes=len(chunk),
                offset=self._offset,
            )
        return len(chunk)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            with self._lock:
                self._ship_locked()

    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._loop, name="netrep-journal-shipper",
                daemon=True,
            )
            self._thread.start()

    def stop(self, final_flush: bool = True) -> None:
        """Stop the tailing thread (joined), optionally running one last
        ship pass so everything fsynced at the source is on the copy."""
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)
        if final_flush:
            self.flush()


def pack_checkpoint_path(ckpt_dir: str, cfg_id: str, members) -> str:
    """Deterministic per-pack checkpoint path: a digest of the member
    requests' durable identities (journal key, seed, n_perm, plan
    signature) plus the engine-config identity. The same requests
    re-queued by a recovering boot re-form the same pack and find the same
    checkpoint; any other composition hashes elsewhere and simply
    recomputes (recovery parity never depends on the resume firing — the
    checkpoint is a work-saving optimization, bit-identical either way)."""
    h = hashlib.blake2b(digest_size=12)
    h.update(cfg_id.encode())
    for key, seed, n_perm, sig in sorted(members):
        h.update(f"|{key}:{seed}:{n_perm}:{sig}".encode())
    return os.path.join(ckpt_dir, f"pack_{h.hexdigest()}.npz")

"""Replica lifecycle state machine of the serving fleet.

The port of ``netrep_tpu/serve/lifecycle.py`` (host code, copied: the port
imports nothing of the JAX package). It pins which states a fleet replica
has and which moves between them are legal::

    spawning ──► ready ──► draining ──► dead ──► spawning (gen+1)
        │          │                      ▲
        │          └──────────────────────┤   (unnoticed loss:
        └─────────────────────────────────┘    crash, wedge)

- **spawning**: the worker is booting; not on the ring yet.
- **ready**: serving — on the ring, shipping its journal.
- **draining**: leaving *on purpose* (autoscale retire, eviction notice,
  fleet close): removed from the ring first, finishing or journaling its
  backlog, tail pre-shipped to the peer. The state that makes a noticed
  eviction a *handoff* instead of a failover.
- **dead**: gone. A respawn re-enters ``spawning`` with the generation
  bumped.

Every transition emits ONE ``replica_state`` telemetry event carrying the
``replica`` label plus ``prev``/``to``/``gen``/``reason``. Illegal
transitions raise :class:`IllegalTransition`: a coordinator bug fails
loudly at the transition site. :data:`LEGAL_TRANSITIONS` equals the JAX
package's table exactly (``tests/test_torch_fleet.py``).
"""

from __future__ import annotations

import threading

from .scheduler import ServeError

#: the four replica states, in nominal order
SPAWNING = "spawning"
READY = "ready"
DRAINING = "draining"
DEAD = "dead"

STATES = (SPAWNING, READY, DRAINING, DEAD)

#: the complete legal-move table — anything absent raises; adding an edge
#: is a contract change
LEGAL_TRANSITIONS = frozenset({
    (SPAWNING, READY),      # boot completed: worker running
    (SPAWNING, DEAD),       # boot failure (never reached the ring)
    (READY, DRAINING),      # retire / eviction notice / fleet close
    (READY, DEAD),          # unnoticed loss: crash, wedge
    (DRAINING, DEAD),       # drain finished (or its bounded grace did)
    (DEAD, SPAWNING),       # respawn — generation bumps (g+1)
})


class IllegalTransition(ServeError):
    """A lifecycle move outside :data:`LEGAL_TRANSITIONS` — a coordinator
    bug (e.g. draining an already-dead replica), raised at the transition
    site."""


class ReplicaLifecycle:
    """One replica's lifecycle: current state, generation counter, and the
    telemetry event every transition owes. Thread-safe — the health loop,
    the autoscaler and client threads all observe it."""

    def __init__(self, rid: str, *, generation: int = 0,
                 telemetry=None, parent: str | None = None):
        self.rid = rid
        self._state = SPAWNING
        self._generation = int(generation)
        self._tel = telemetry
        self._parent = parent
        self._lock = threading.Lock()

    def bind(self, telemetry, parent: str | None = None) -> None:
        """Attach the coordinator's telemetry bus (and its serve span as
        the parent) — replica handles are built before the coordinator
        exists, so the bus arrives at ``join`` time."""
        with self._lock:
            self._tel = telemetry
            self._parent = parent

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def transition(self, to: str, *, reason: str = "", **data) -> str:
        """Move to ``to`` (validated against the table), bump the
        generation on a respawn (``dead → spawning``), and emit the
        ``replica_state`` event. Returns the new state."""
        if to not in STATES:
            raise IllegalTransition(
                f"replica {self.rid}: unknown lifecycle state {to!r}"
            )
        with self._lock:
            prev = self._state
            if (prev, to) not in LEGAL_TRANSITIONS:
                raise IllegalTransition(
                    f"replica {self.rid}: illegal lifecycle transition "
                    f"{prev!r} -> {to!r} (reason={reason!r})"
                )
            if prev == DEAD and to == SPAWNING:
                self._generation += 1
            self._state = to
            gen = self._generation
            tel, parent = self._tel, self._parent
        if tel is not None:
            tel.emit("replica_state", replica=self.rid, prev=prev,
                     to=to, gen=gen, reason=reason, parent=parent,
                     **data)
        return to

"""Wire protocol of the serving daemon.

The port of ``netrep_tpu/serve/protocol.py`` (host code, copied: the port
imports nothing of the JAX package). One JSON object per line in both
directions; no HTTP framework. Requests carry an ``op`` discriminator;
responses always carry ``ok`` (and ``error`` when false). Arrays travel as
nested lists — the clients re-materialize the result keys in
:data:`ARRAY_KEYS` as numpy.

Ops (see :func:`netrep_tpu_torch.serve.server.dispatch_op` for the
executable definition)::

    ping               liveness
    register_fixture   server-side deterministic fixture registration
                       (tenant, prefix, genes, modules, n_samples, seed)
    register           dataset registration with inline matrices
                       (tenant, name, correlation, network, data?,
                        assignments?) — or the data-only payload (tenant,
                       name, data, beta, assignments?): no matrices, the
                       soft-threshold spec ``beta`` (β or [β, kind])
                       derives them on the device, and the returned
                       digest covers the derivation params
    analyze            blocking preservation request (tenant, discovery,
                       test | [tests...], modules?, n_perm?, seed,
                       alternative?, adaptive?, deadline_s?, timeout?,
                       idempotency_key?, trace_ctx?) — the idempotency
                       key is the request's durable identity: a duplicate
                       attaches to the in-flight run or is answered from
                       the journaled result, never recomputed
    metrics            Prometheus text exposition
    stats              queue/pool/tenant counters as JSON
    adopt_journal      replay another server's journal into this one
    shutdown           initiate the graceful drain (same path as SIGTERM)
    evict_notice       noticed preemption: begin the bounded drain now
    dump               a diagnostic bundle; answered with the structured
                       error of an unavailable op (ROADMAP.md Queue 1
                       item 16b)
"""

from __future__ import annotations

import re
import uuid

import numpy as np

#: trace-context wire shape (W3C-trace-context style): every
#: ``analyze`` op may carry ``trace_ctx = {"trace": <32-hex trace id>,
#: "parent": <caller span id | None>}``. The client mints one per LOGICAL
#: request (stable across retries, like the idempotency key) unless the
#: caller supplies its own; the server journals it with the ``accepted``
#: record so a ``--recover`` boot resumes the SAME trace, and stamps it
#: on the request's telemetry span, so the request's whole span subtree
#: (across processes and restarts) carries this one id.
TRACE_ID_RE = re.compile(r"^[0-9a-f]{8,64}$")


def mint_trace_ctx(parent_span: str | None = None) -> dict:
    """A fresh client-side trace context: a 32-hex trace id (W3C trace-id
    sized) plus the caller's parent span id, if it has one."""
    return {"trace": uuid.uuid4().hex, "parent": parent_span}


def normalize_trace_ctx(ctx) -> dict | None:
    """Validate/coerce a caller-supplied trace context; returns the
    canonical ``{"trace", "parent"}`` dict or None for anything
    unusable (a malformed context must never fail the request — tracing
    only observes; the server then mints its own)."""
    if not isinstance(ctx, dict):
        return None
    trace = ctx.get("trace")
    if not (isinstance(trace, str) and TRACE_ID_RE.match(trace)):
        return None
    parent = ctx.get("parent")
    if not (parent is None or isinstance(parent, str)):
        parent = None
    return {"trace": trace, "parent": parent}


#: result keys the wire protocol round-trips as arrays
ARRAY_KEYS = (
    "observed", "p_values", "counts_hi", "counts_lo", "counts_eff",
    "n_perm_used", "n_vars_present", "prop_vars_present", "total_size",
)


def encode_arrays(obj):
    """JSON-serializable deep copy: numpy arrays → nested lists, numpy
    scalars → Python scalars."""
    if isinstance(obj, dict):
        return {k: encode_arrays(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [encode_arrays(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj


def decode_arrays(obj):
    """Inverse of :func:`encode_arrays` for result payloads: the
    :data:`ARRAY_KEYS` fields (including inside nested payloads — the
    wire response wraps the result one level down, and multi-test
    results carry per-test sub-results) come back as numpy arrays."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k in ARRAY_KEYS and v is not None:
                out[k] = np.asarray(v)
            elif k == "tests" and isinstance(v, list):
                out[k] = [decode_arrays(t) for t in v]
            elif isinstance(v, dict):
                out[k] = decode_arrays(v)
            else:
                out[k] = v
        return out
    return obj

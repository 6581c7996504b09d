"""The invariant rule catalogue of the port.

The port of ``netrep_tpu/analysis/rules.py``, aimed at the port's own
contracts. Every contract that makes the bit-identity story hold — the
``fold_in(key, i)`` RNG discipline of :mod:`netrep_tpu_torch.random`, the
fault-taxonomy rule that bugs never silently retry, the pinned telemetry
schema, the ``x_`` checkpoint-extras namespace, a ``run_key()`` that names
every field changing which kernels and shapes run, and lock discipline
around cross-thread state — is an AST-level :class:`Rule`, so ``python -m
netrep_tpu_torch lint`` machine-checks it on every commit. Three rules
are the port's own, in place of the JAX package's ``donation-alias``
(PyTorch has no buffer donation): ``port-imports`` (nothing of JAX or of
the JAX package), ``tf32-off`` (float32 matrix products stay float32) and
``no-device-fallback`` (no quiet road from the card to the CPU or from a
kernel to its plain version).

A rule is any object with ``name``, ``description``, and
``check(module) -> list[Finding]``; :func:`default_rules` is the active
set the walker (:mod:`netrep_tpu_torch.analysis.linter`) runs. Rules are
pure functions of the parsed source — no imports of the module under
analysis, no execution — so the linter is safe on broken or unimportable
files. Like the JAX rules they check what the code holds, not every path
through it.

Suppressions: a finding on line *L* is silenced by a comment on *L* or
*L-1* of the form ``# netrep: allow(<rule>) — <reason>`` (see
:mod:`netrep_tpu_torch.analysis.linter` for the grammar). Suppressions are
counted and reported — a justified exception is still an exception.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Iterable, Iterator, Protocol

#: the port's package name: relative imports resolve under it
PACKAGE = "netrep_tpu_torch"
#: where a file outside the package is taken to sit when its relative
#: imports are resolved: a null-path subpackage of the port, so a fixture's
#: ``from .. import random`` names the port's random module
FIXTURE_PACKAGE = f"{PACKAGE}.parallel"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a file/line."""

    rule: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class Module:
    """A parsed source file plus the cheap derived views rules share:
    the import alias map, the source lines, and the path's position
    relative to the port's root (``pkg_rel`` is ``None`` for files
    outside ``netrep_tpu_torch/`` — rule scoping treats those as always
    in scope, so test fixtures exercise every rule without path games)."""

    def __init__(self, path: str, source: str, pkg_rel: str | None = None):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.pkg_rel = pkg_rel
        self.aliases = _import_aliases(self.tree, _package_of(pkg_rel))

    def in_scope(self, top_dirs: tuple[str, ...]) -> bool:
        """True when this module falls under one of the port's
        ``top_dirs`` subpackages — or is not a port file at all
        (fixtures are always in scope)."""
        if self.pkg_rel is None:
            return True
        head = self.pkg_rel.replace("\\", "/").split("/", 1)[0]
        return head in top_dirs

    def dotted(self, node: ast.AST) -> str | None:
        """Resolve an attribute chain (``np.random.default_rng``) to its
        canonical dotted name (``numpy.random.default_rng``) using the
        module's import aliases; ``None`` for non-name expressions."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        root = self.aliases.get(parts[0])
        if root is not None:
            parts[0:1] = root.split(".")
        return ".".join(parts)


def _package_of(pkg_rel: str | None) -> str:
    """The dotted package a module at ``pkg_rel`` (relative to the port's
    root) belongs to; :data:`FIXTURE_PACKAGE` for a file outside it."""
    if pkg_rel is None:
        return FIXTURE_PACKAGE
    dirs = pkg_rel.replace("\\", "/").split("/")[:-1]
    return ".".join([PACKAGE, *dirs])


def _absolute(node: ast.ImportFrom, package: str) -> str | None:
    """The absolute module an ``ImportFrom`` names (relative ones resolved
    against ``package``), or None when it climbs above the root."""
    if not node.level:
        return node.module
    parts = package.split(".")
    if node.level - 1 >= len(parts):
        return None
    base = parts[:len(parts) - (node.level - 1)]
    return ".".join(base + ([node.module] if node.module else []))


def _import_aliases(tree: ast.Module, package: str) -> dict[str, str]:
    """Name → dotted-module map from every import statement in the file
    (function-level imports included — the repo defers heavy imports;
    relative imports resolved against ``package``)."""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom):
            base = _absolute(node, package)
            if base is None:
                continue
            for a in node.names:
                out[a.asname or a.name] = f"{base}.{a.name}"
    return out


def _body_calls(body: Iterable[ast.AST]) -> Iterator[ast.AST]:
    """Walk statement bodies without descending into nested function or
    class definitions (their contracts are checked at their own site)."""
    stack = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


class Rule(Protocol):
    """The rule protocol: a name (the suppression/selection key), a
    one-line description for the catalogue, and a pure AST check."""

    name: str
    description: str

    def check(self, mod: Module) -> list[Finding]:  # pragma: no cover
        ...


# ---------------------------------------------------------------------------
# 1. rng-discipline
# ---------------------------------------------------------------------------

class RngDiscipline:
    """Inside the null-path subpackages (``parallel/``, ``ops/``,
    ``atlas/``) the ONLY legal randomness is a stream derived from the
    run key by :mod:`netrep_tpu_torch.random`: ``fold_in(key, i)``,
    ``perm_keys`` (the chunk's ``fold_in`` keys), ``permutation`` and the
    key-data helpers (``ThreefryKey``, ``ThreefryKey.from_data``) — the
    contract that makes results independent of chunk size, mesh shape,
    resume point, serve packing, and equal to the JAX package's. Creating
    fresh keys or forking them (``key``, ``split`` or any other member),
    torch's RNG (``torch.manual_seed``, ``torch.Generator``,
    ``torch.rand``..., in-place ``.random_``/``.uniform_``/``.normal_``),
    host RNGs (``np.random.*``, stdlib ``random.*``), or wall-clock
    entropy (``time.time``) on a null path silently breaks bit-identity;
    sanctioned sites (the root-key constructor, fixed-seed sample
    positions of an input check) carry a reasoned suppression."""

    name = "rng-discipline"
    description = ("null-path modules may only use fold_in-derived RNG "
                   "streams (no key creation/split, torch RNG, np.random, "
                   "stdlib random, or time.time)")

    SCOPE = ("parallel", "ops", "atlas")
    RANDOM = f"{PACKAGE}.random."
    #: members of the port's random module that CONSUME an existing key
    #: (legal) rather than create or fork one (illegal on null paths)
    ALLOWED_RANDOM = frozenset(
        {"fold_in", "perm_keys", "permutation", "ThreefryKey", "from_data"}
    )
    TORCH_RNG = frozenset({
        "manual_seed", "seed", "Generator", "rand", "randn", "randint",
        "randperm", "normal", "bernoulli", "multinomial",
    })
    INPLACE_RNG = frozenset({"random_", "uniform_", "normal_"})

    def check(self, mod: Module) -> list[Finding]:
        if not mod.in_scope(self.SCOPE):
            return []
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            d = mod.dotted(node.func) or ""
            msg = None
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in self.INPLACE_RNG):
                msg = (f".{node.func.attr}() fills a tensor from torch's "
                       "RNG on a null path — results must derive from "
                       "fold_in(key, i) only")
            elif d.startswith(self.RANDOM):
                tail = d.rsplit(".", 1)[1]
                if tail not in self.ALLOWED_RANDOM:
                    msg = (f"{d}() creates/forks a PRNG stream on a null "
                           "path — only fold_in-derived streams keep "
                           "results chunk/mesh/resume-independent")
            elif (d.startswith("torch.")
                  and d.rsplit(".", 1)[1] in self.TORCH_RNG):
                msg = (f"{d}() is torch's RNG on a null path — results "
                       "must derive from fold_in(key, i) only")
            elif d.startswith("numpy.random."):
                msg = (f"{d}() is host randomness on a null path — "
                       "results must derive from fold_in(key, i) only")
            elif d == "time.time":
                msg = ("time.time() is wall-clock entropy on a null path "
                       "— use deterministic inputs (perf_counter/"
                       "monotonic are fine for telemetry durations)")
            elif d.startswith("random.") and mod.aliases.get(
                    "random") == "random":
                msg = (f"stdlib {d}() on a null path — only "
                       f"fold_in-derived {PACKAGE}.random streams are "
                       "legal")
            if msg is not None:
                out.append(Finding(self.name, mod.path, node.lineno, msg))
        return out


# ---------------------------------------------------------------------------
# 2. exception-taxonomy
# ---------------------------------------------------------------------------

class ExceptionTaxonomy:
    """The fault taxonomy (``utils/faults.py``) draws one line: transient
    device faults retry, BUGS NEVER SILENTLY RETRY (or vanish). A bare
    ``except:`` / ``except Exception`` / ``except BaseException`` that
    swallows is where a bug becomes a silent wrong answer. Every broad
    handler must re-raise (any ``raise`` in the handler), route through
    ``faults.classify_error``, or carry a reasoned suppression naming why
    swallowing is the contract at that site (observer code that must
    never kill the run, import-time optional dependencies)."""

    name = "exception-taxonomy"
    description = ("broad except handlers must re-raise, classify via "
                   "faults.classify_error, or carry a justification "
                   "suppression")

    BROAD = frozenset({"Exception", "BaseException"})

    def _is_broad(self, handler: ast.ExceptHandler) -> bool:
        t = handler.type
        if t is None:
            return True
        names = t.elts if isinstance(t, ast.Tuple) else [t]
        return any(isinstance(n, ast.Name) and n.id in self.BROAD
                   for n in names)

    def check(self, mod: Module) -> list[Finding]:
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not self._is_broad(node):
                continue
            handled = False
            for sub in _body_calls(node.body):
                if isinstance(sub, ast.Raise):
                    handled = True
                    break
                if (isinstance(sub, ast.Call)
                        and (mod.dotted(sub.func) or "").rsplit(
                            ".", 1)[-1] == "classify_error"):
                    handled = True
                    break
            if not handled:
                caught = ("bare except" if node.type is None
                          else f"except {ast.unparse(node.type)}")
                out.append(Finding(
                    self.name, mod.path, node.lineno,
                    f"{caught} swallows without re-raising or "
                    "classify_error — bugs must never silently retry or "
                    "vanish (faults.py taxonomy); narrow the type, "
                    "re-raise, or justify with a suppression",
                ))
        return out


# ---------------------------------------------------------------------------
# 3. telemetry-registry
# ---------------------------------------------------------------------------

class TelemetryRegistry:
    """Every literal event name passed to ``emit()`` / ``begin_span()`` /
    ``span()`` / ``end_span()`` must belong to the pinned registries in
    the port's ``utils/telemetry.py`` (``KNOWN_EVENTS``: the JAX package's
    schema). Dashboards, the CLI's report and the JAX package's readers
    key on these names — an unregistered emit is schema drift that no
    test notices until a dashboard goes dark."""

    name = "telemetry-registry"
    description = ("literal event names in emit()/begin_span()/span()/"
                   "end_span() must be members of the pinned telemetry "
                   "registries")

    def __init__(self, known: frozenset[str] | None = None):
        if known is None:
            from ..utils.telemetry import KNOWN_EVENTS

            known = KNOWN_EVENTS
        self.known = known

    def check(self, mod: Module) -> list[Finding]:
        out = []
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            attr = node.func.attr
            if attr in ("emit", "begin_span", "span"):
                pos = 0
            elif attr == "end_span":
                pos = 1  # end_span(span_id, ev, ...)
            else:
                continue
            if len(node.args) <= pos:
                continue
            arg = node.args[pos]
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                continue  # dynamic names are the caller's responsibility
            if arg.value not in self.known:
                out.append(Finding(
                    self.name, mod.path, arg.lineno,
                    f"event name {arg.value!r} is not in any pinned "
                    "telemetry registry (KNOWN_EVENTS) — register it or "
                    "the schema drifts silently under every dashboard "
                    "keyed on it",
                ))
        return out


# ---------------------------------------------------------------------------
# 4. span-pairing
# ---------------------------------------------------------------------------

class SpanPairing:
    """Loop-shaped spans (``begin_span``/``end_span``) are the one place
    the trace tree can leak: a ``begin_span`` whose ``end_span`` never
    ships renders every later event under a span that never closes, and
    the time-split/Perfetto exports mis-nest silently (context-manager
    ``span()`` cannot leak — the ``with`` closes it). The contract: a
    function that calls ``begin_span`` must also contain the matching
    ``end_span``; when the span id is handed off through a ``self``
    attribute (the server-lifetime ``serve_start`` span, opened in
    ``__init__`` and closed in ``close()``), the ``end_span`` may live in
    any method of the same class. This is deliberately presence-based,
    not full path analysis: the crash path MAY skip the end (begin-only
    spans render zero-width by design — a crashed run must still
    export); what it catches is the end never being written at all."""

    name = "span-pairing"
    description = ("every begin_span() needs its end_span in the same "
                   "function (or, for self-attribute span ids, in the "
                   "same class)")

    @staticmethod
    def _calls(fn: ast.FunctionDef, attr: str) -> list[ast.Call]:
        out = []
        for node in _body_calls(fn.body):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == attr):
                out.append(node)
        return out

    @staticmethod
    def _assigns_to_self(fn: ast.FunctionDef, call: ast.Call) -> bool:
        """Whether the begin_span result is stored on ``self`` (the
        cross-method handoff shape: ``self._sid = tel.begin_span(...)``,
        possibly behind a conditional)."""
        for node in _body_calls(fn.body):
            if not isinstance(node, ast.Assign):
                continue
            if node.value is not call:
                continue
            for t in node.targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    return True
        return False

    def check(self, mod: Module) -> list[Finding]:
        out = []
        # class context per function: a self-attribute handoff may close
        # in any sibling method
        class_of: dict[ast.FunctionDef, ast.ClassDef | None] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, ast.FunctionDef):
                        class_of[item] = node
        for fn in [n for n in ast.walk(mod.tree)
                   if isinstance(n, ast.FunctionDef)]:
            begins = self._calls(fn, "begin_span")
            if not begins:
                continue
            if self._calls(fn, "end_span"):
                continue
            cls = class_of.get(fn)
            for call in begins:
                if cls is not None and self._assigns_to_self(fn, call):
                    closed = any(
                        isinstance(m, ast.FunctionDef)
                        and self._calls(m, "end_span")
                        for m in cls.body
                    )
                    if closed:
                        continue
                ev = ""
                if call.args and isinstance(call.args[0], ast.Constant):
                    ev = f" ({call.args[0].value!r})"
                out.append(Finding(
                    self.name, mod.path, call.lineno,
                    f"begin_span{ev} has no matching end_span in "
                    f"{fn.name}()"
                    + (" or its class" if cls is not None else "")
                    + " — the span never closes and every later event "
                      "mis-nests under it; emit the end (crash paths may "
                      "skip it at runtime) or justify with a suppression",
                ))
        return out


# ---------------------------------------------------------------------------
# 5. checkpoint-extras-namespace
# ---------------------------------------------------------------------------

class CheckpointExtrasNamespace:
    """Checkpoint auxiliary state rides ``save_null_checkpoint(...,
    extra={...})`` and is serialized under an ``x_`` prefix so plain
    resumes ignore it. Caller-side literal keys must therefore be bare
    (the writer prefixes; an ``x_``-prefixed key would double-prefix and
    orphan the state on resume) and must not shadow the reserved
    top-level npz names. The second half of the contract is the run's
    identity: any ``run_key()`` method (the key of ``compile_span``
    events and perf-ledger entries, the port's counterpart of the JAX
    ``autotune_key``) must consult every field that changes which kernels
    and shapes run — the statistics path, the storage type, the bucket
    signature, the effective chunk, the data-only derivation — otherwise
    two different runs share one fingerprint and the regression gate
    compares apples to oranges."""

    name = "checkpoint-extras-namespace"
    description = ("checkpoint extra= keys must be bare identifiers "
                   "(writer adds the x_ prefix) outside the reserved "
                   "set; run_key() must consult every field that "
                   "changes which kernels and shapes run")

    RESERVED = frozenset(
        {"version", "nulls", "completed", "key_data", "fingerprint"}
    )
    #: engine/config fields that change which kernels and shapes run, each
    #: with the attribute names that consult it
    FINGERPRINT_FIELDS = {
        "stat_mode": ("stat_mode",),
        "dtype": ("dtype",),
        "buckets": ("buckets", "_buckets_full"),
        "effective_chunk": ("effective_chunk",),
        "data_only": ("data_only",),
    }

    def check(self, mod: Module) -> list[Finding]:
        out = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                d = mod.dotted(node.func) or ""
                if d.rsplit(".", 1)[-1] != "save_null_checkpoint":
                    continue
                for kw in node.keywords:
                    if kw.arg != "extra" or not isinstance(kw.value,
                                                          ast.Dict):
                        continue
                    for k in kw.value.keys:
                        if not (isinstance(k, ast.Constant)
                                and isinstance(k.value, str)):
                            continue
                        key = k.value
                        bad = None
                        if key.startswith("x_"):
                            bad = ("already x_-prefixed — the writer "
                                   "prefixes again and the resume path "
                                   "never finds it")
                        elif key in self.RESERVED:
                            bad = ("shadows a reserved checkpoint field "
                                   "after prefixing conventions change")
                        elif not key.isidentifier():
                            bad = "not a bare identifier"
                        if bad:
                            out.append(Finding(
                                self.name, mod.path, k.lineno,
                                f"checkpoint extra key {key!r} {bad}",
                            ))
            elif (isinstance(node, ast.ClassDef)):
                for item in node.body:
                    if (isinstance(item, ast.FunctionDef)
                            and item.name == "run_key"):
                        out.extend(self._check_run_key(mod, item))
        return out

    def _check_run_key(self, mod: Module,
                       fn: ast.FunctionDef) -> list[Finding]:
        seen: set[str] = set()
        for node in ast.walk(fn):
            # delegation (super().run_key() / self.cohorts[0].run_key())
            # inherits the delegate's field coverage — checked at ITS site
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "run_key"):
                return []
            # every attribute of a chain rooted at self counts
            # (self.config.dtype consults both config and dtype)
            if isinstance(node, ast.Attribute):
                chain, base = [], node
                while isinstance(base, ast.Attribute):
                    chain.append(base.attr)
                    base = base.value
                if isinstance(base, ast.Name) and base.id == "self":
                    seen.update(chain)
            # getattr(self, "field", default) counts as consulting it
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "getattr"
                    and len(node.args) >= 2
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id == "self"
                    and isinstance(node.args[1], ast.Constant)):
                seen.add(str(node.args[1].value))
        missing = [f for f, names in self.FINGERPRINT_FIELDS.items()
                   if not seen.intersection(names)]
        if not missing:
            return []
        return [Finding(
            self.name, mod.path, fn.lineno,
            "run_key() does not consult the field(s) "
            f"{missing} that change which kernels and shapes run — "
            "distinct runs would share one compile-span/perf-ledger "
            "fingerprint",
        )]


# ---------------------------------------------------------------------------
# 6. thread-shared-state
# ---------------------------------------------------------------------------

class ThreadSharedState:
    """Lock discipline over the scheduler/journal/pool/telemetry/
    checkpoint-writer thread seams: in any class that launches a
    ``threading.Thread`` at one of its own methods, a ``self._*``
    attribute written on one side of the thread boundary and touched on
    the other must only ever be accessed under that class's lock or
    condition (``with self._lock:`` / ``with self._cond:``), inside a
    ``*_locked``-suffixed method (the repo's caller-holds-the-lock
    convention), or carry a reasoned suppression. Synchronization
    primitives themselves (locks, conditions, events, thread handles)
    are exempt — they are their own synchronization. ``__init__`` is
    pre-thread and exempt."""

    name = "thread-shared-state"
    description = ("cross-thread self._* state in thread-launching "
                   "classes must be accessed under the class lock/"
                   "condition (or in *_locked methods)")

    SYNC_CTORS = frozenset({"Lock", "RLock", "Condition", "Event",
                            "Semaphore", "BoundedSemaphore", "Barrier",
                            "Thread", "local"})
    _GUARD_NAME = re.compile(r"lock|cond|mutex")

    def check(self, mod: Module) -> list[Finding]:
        out = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                out.extend(self._check_class(mod, node))
        return out

    # -- helpers ----------------------------------------------------------

    def _sync_attrs(self, cls: ast.ClassDef) -> set[str]:
        """Attributes holding synchronization primitives / thread
        handles — exempt from the guard requirement, and (for locks and
        conditions) the guards themselves."""
        sync: set[str] = set()
        for node in ast.walk(cls):
            target = None
            value: ast.AST | None = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target, value = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign):
                target, value = node.target, node.annotation
            if not (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"):
                # dataclass field declaration: name: threading.Event = ...
                if (isinstance(node, ast.AnnAssign)
                        and isinstance(node.target, ast.Name)
                        and self._is_sync_expr(node.annotation)):
                    sync.add(node.target.id)
                continue
            if value is not None and self._is_sync_expr(value):
                sync.add(target.attr)
        return sync

    def _is_sync_expr(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Call):
            node = node.func
        if isinstance(node, ast.Attribute):
            return node.attr in self.SYNC_CTORS
        if isinstance(node, ast.Name):
            return node.id in self.SYNC_CTORS
        if isinstance(node, (ast.BinOp, ast.Subscript, ast.Constant)):
            # annotations like "threading.Thread | None"
            return any(self._is_sync_expr(c)
                       for c in ast.iter_child_nodes(node))
        return False

    def _thread_targets(self, cls: ast.ClassDef) -> set[str]:
        """Names of methods that RUN on a spawned thread: the methods
        launched as Thread targets from within the class
        (``threading.Thread(target=self._loop, ...)``) plus the
        transitive closure of ``self.method()`` calls from them — a
        helper invoked by the worker loop executes on the worker thread
        even though no Thread names it."""
        roots: set[str] = set()
        for node in ast.walk(cls):
            if not (isinstance(node, ast.Call)
                    and self._is_thread_ctor(node.func)):
                continue
            for kw in node.keywords:
                if (kw.arg == "target"
                        and isinstance(kw.value, ast.Attribute)
                        and isinstance(kw.value.value, ast.Name)
                        and kw.value.value.id == "self"):
                    roots.add(kw.value.attr)
        if not roots:
            return roots
        calls: dict[str, set[str]] = {}
        for m in cls.body:
            if not isinstance(m, ast.FunctionDef):
                continue
            callees: set[str] = set()
            for node in ast.walk(m):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "self"):
                    callees.add(node.func.attr)
            calls[m.name] = callees
        closed, frontier = set(roots), list(roots)
        while frontier:
            for callee in calls.get(frontier.pop(), ()):
                if callee in calls and callee not in closed:
                    closed.add(callee)
                    frontier.append(callee)
        return closed

    @staticmethod
    def _is_thread_ctor(func: ast.AST) -> bool:
        return ((isinstance(func, ast.Attribute) and func.attr == "Thread")
                or (isinstance(func, ast.Name) and func.id == "Thread"))

    def _is_guard(self, expr: ast.AST, sync: set[str]) -> bool:
        if isinstance(expr, ast.Attribute) and isinstance(
                expr.value, ast.Name) and expr.value.id == "self":
            return (expr.attr in sync
                    or bool(self._GUARD_NAME.search(expr.attr)))
        return False

    def _accesses(self, method: ast.FunctionDef, sync: set[str]):
        """Yield ``(attr, line, is_write, guarded)`` for every
        ``self._*`` access in the method, tracking ``with self._lock:``
        nesting (no descent into nested functions — closures run on
        whatever thread calls them, checked at their own site if they
        are methods)."""
        guarded_always = method.name.endswith("_locked")

        def walk(node: ast.AST, depth: int):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                return
            inner = depth
            if isinstance(node, ast.With):
                if any(self._is_guard(item.context_expr, sync)
                       for item in node.items):
                    inner += 1
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and node.attr.startswith("_")
                    and node.attr not in sync):
                yield (node.attr, node.lineno,
                       isinstance(node.ctx, (ast.Store, ast.Del)),
                       guarded_always or inner > 0)
            for child in ast.iter_child_nodes(node):
                yield from walk(child, inner)

        for stmt in method.body:
            yield from walk(stmt, 0)

    def _check_class(self, mod: Module,
                     cls: ast.ClassDef) -> list[Finding]:
        targets = self._thread_targets(cls)
        if not targets:
            return []
        sync = self._sync_attrs(cls)
        methods = [n for n in cls.body if isinstance(n, ast.FunctionDef)]
        # attr -> {"target": [...accesses...], "other": [...]}
        by_attr: dict[str, dict[str, list]] = {}
        for m in methods:
            if m.name == "__init__":
                continue  # pre-thread construction
            side = "target" if m.name in targets else "other"
            for attr, line, is_write, guarded in self._accesses(m, sync):
                rec = by_attr.setdefault(attr, {"target": [], "other": []})
                rec[side].append((m.name, line, is_write, guarded))
        out = []
        for attr, rec in sorted(by_attr.items()):
            crosses = (
                (any(w for _, _, w, _ in rec["target"])
                 and rec["other"])
                or (any(w for _, _, w, _ in rec["other"])
                    and rec["target"])
            )
            if not crosses:
                continue
            for side in ("target", "other"):
                for meth, line, is_write, guarded in rec[side]:
                    if guarded:
                        continue
                    kind = "written" if is_write else "read"
                    out.append(Finding(
                        self.name, mod.path, line,
                        f"self.{attr} is shared across the "
                        f"{cls.name} thread boundary but {kind} in "
                        f"{meth}() outside the class lock/condition — "
                        "guard it (with self._lock / *_locked method) "
                        "or justify with a suppression",
                    ))
        # deterministic order for stable reports
        out.sort(key=lambda f: f.line)
        return out


# ---------------------------------------------------------------------------
# 7. port-imports
# ---------------------------------------------------------------------------

class PortImports:
    """The port runs where JAX does not: it imports ``torch``, ``numpy``
    and ``scipy`` and keeps its own copy of whatever it needs from the JAX
    package, even of a module there that does not import JAX. An
    ``import`` or absolute ``from`` of ``jax``, ``jaxlib`` or
    ``netrep_tpu`` (a submodule included) breaks the port on a machine
    without JAX, and ties it to the reference it is tested against.
    Relative imports stay inside the port."""

    name = "port-imports"
    description = ("no import or absolute from-import of jax, jaxlib or "
                   "netrep_tpu")

    FORBIDDEN = ("jax", "jaxlib", "netrep_tpu")

    def _forbidden(self, name: str) -> bool:
        return any(name == f or name.startswith(f + ".")
                   for f in self.FORBIDDEN)

    def check(self, mod: Module) -> list[Finding]:
        out = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                bad = [a.name for a in node.names if self._forbidden(a.name)]
            elif (isinstance(node, ast.ImportFrom) and node.level == 0
                  and node.module and self._forbidden(node.module)):
                bad = [node.module]
            else:
                continue
            for name in bad:
                out.append(Finding(
                    self.name, mod.path, node.lineno,
                    f"imports {name} — the port never imports JAX or the "
                    "JAX package; keep a copy of what it needs in "
                    f"{PACKAGE}/",
                ))
        return out


# ---------------------------------------------------------------------------
# 8. tf32-off
# ---------------------------------------------------------------------------

class Tf32Off:
    """Float32 matrix products stay float32: the port holds its values to
    the JAX package's within 1e-5 on the CPU and 1e-4 on the card, which
    TF32's 10-bit mantissa would break. ``utils/__init__.py`` turns TF32
    off once; this rule flags any assignment of anything but ``False`` to
    ``torch.backends.cuda.matmul.allow_tf32`` or
    ``torch.backends.cudnn.allow_tf32``, and any
    ``torch.set_float32_matmul_precision`` other than ``"highest"``."""

    name = "tf32-off"
    description = ("allow_tf32 may only be set to False, and "
                   "set_float32_matmul_precision only to 'highest'")

    FLAGS = frozenset({"torch.backends.cuda.matmul.allow_tf32",
                       "torch.backends.cudnn.allow_tf32"})

    def check(self, mod: Module) -> list[Finding]:
        out = []
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                value = node.value
                for t in targets:
                    d = mod.dotted(t)
                    if d not in self.FLAGS:
                        continue
                    if (isinstance(node, ast.AugAssign)
                            or not (isinstance(value, ast.Constant)
                                    and value.value is False)):
                        out.append(Finding(
                            self.name, mod.path, node.lineno,
                            f"{d} set to something other than False — "
                            "TF32 rounds float32 products to 10 mantissa "
                            "bits, beyond the port's tolerances",
                        ))
            elif (isinstance(node, ast.Call)
                  and mod.dotted(node.func)
                  == "torch.set_float32_matmul_precision"):
                arg = (node.args[0] if node.args else next(
                    (k.value for k in node.keywords
                     if k.arg == "precision"), None))
                if not (isinstance(arg, ast.Constant)
                        and arg.value == "highest"):
                    out.append(Finding(
                        self.name, mod.path, node.lineno,
                        "set_float32_matmul_precision other than "
                        "'highest' lets float32 products round through "
                        "TF32 or bfloat16",
                    ))
        return out


# ---------------------------------------------------------------------------
# 9. no-device-fallback
# ---------------------------------------------------------------------------

class NoDeviceFallback:
    """The device rules: an entry point runs on the card unless the caller
    names the CPU, raises without a card, and a kernel wrapper launches
    its kernel (or raises) for a CUDA tensor — there is no fallback
    anywhere. Three shapes of a fallback are flagged: a conditional on
    ``torch.cuda.is_available()`` or ``torch.cuda.device_count()`` whose
    branch yields a CPU device (``"cpu"`` or ``torch.device("cpu")``); an
    ``except`` handler whose body calls a kernel's plain version (a
    ``*_plain`` function); and a public function whose ``device``
    parameter defaults to ``"cpu"``."""

    name = "no-device-fallback"
    description = ("no CPU device chosen on torch.cuda.is_available()/"
                   "device_count(), no *_plain call in an except handler, "
                   "no public device='cpu' default")

    PROBES = frozenset({"torch.cuda.is_available",
                        "torch.cuda.device_count"})

    def _probes(self, mod: Module, expr: ast.AST) -> bool:
        return any(isinstance(n, ast.Call)
                   and mod.dotted(n.func) in self.PROBES
                   for n in ast.walk(expr))

    @staticmethod
    def _is_cpu(mod: Module, node: ast.AST) -> bool:
        if isinstance(node, ast.Constant) and node.value == "cpu":
            return True
        return (isinstance(node, ast.Call)
                and mod.dotted(node.func) == "torch.device"
                and bool(node.args)
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == "cpu")

    def _yields_cpu(self, mod: Module, branch) -> bool:
        nodes = branch if isinstance(branch, list) else [branch]
        return any(self._is_cpu(mod, n) for n in _body_calls(nodes))

    @staticmethod
    def _public(fn, parents) -> bool:
        if fn.name == "__init__":
            cls = parents.get(fn)
            return cls is not None and not cls.name.startswith("_")
        return not fn.name.startswith("_")

    def check(self, mod: Module) -> list[Finding]:
        out = []
        parents = {item: node for node in ast.walk(mod.tree)
                   if isinstance(node, ast.ClassDef) for item in node.body}
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.If, ast.IfExp)):
                if (self._probes(mod, node.test)
                        and (self._yields_cpu(mod, node.body)
                             or self._yields_cpu(mod, node.orelse))):
                    out.append(Finding(
                        self.name, mod.path, node.lineno,
                        "a branch on the card's presence yields a CPU "
                        "device — without a card the call must raise; "
                        "the CPU runs only when the caller names it",
                    ))
            elif isinstance(node, ast.ExceptHandler):
                for sub in _body_calls(node.body):
                    if not isinstance(sub, ast.Call):
                        continue
                    d = mod.dotted(sub.func) or ""
                    if d.rsplit(".", 1)[-1].endswith("_plain"):
                        out.append(Finding(
                            self.name, mod.path, sub.lineno,
                            f"{d}() in an except handler — a kernel that "
                            "fails must raise, never give way to its "
                            "plain version",
                        ))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if not self._public(node, parents):
                    continue
                a = node.args
                pos = a.posonlyargs + a.args
                pairs = list(zip(pos[len(pos) - len(a.defaults):],
                                 a.defaults))
                pairs += [(k, v) for k, v in zip(a.kwonlyargs,
                                                 a.kw_defaults)
                          if v is not None]
                for arg, default in pairs:
                    if arg.arg == "device" and self._is_cpu(mod, default):
                        out.append(Finding(
                            self.name, mod.path, default.lineno,
                            f"{node.name}() defaults device to the CPU — "
                            "entry points take device=None, meaning the "
                            "card",
                        ))
        return out


def default_rules() -> tuple:
    """The active rule set, constructed fresh (the telemetry rule loads
    the pinned registries at construction)."""
    return (
        RngDiscipline(),
        ExceptionTaxonomy(),
        TelemetryRegistry(),
        SpanPairing(),
        CheckpointExtrasNamespace(),
        ThreadSharedState(),
        PortImports(),
        Tf32Off(),
        NoDeviceFallback(),
    )

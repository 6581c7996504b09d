"""The port's invariant linter (``netrep_tpu_torch/analysis``), case for
case with ``tests/test_lint.py``:

1. every rule FIRES on a minimal violating fixture and stays quiet on a
   compliant one (a rule that cannot fire is a disabled contract) — the
   JAX package's rules aimed at the port, and the port's own three
   (``port-imports``, ``tf32-off``, ``no-device-fallback``);
2. the suppression grammar is honored AND tallied (a justified exception
   is counted, a reasonless one is itself a finding);
3. the rules shared with the JAX package give its findings on the same
   sources, and the JSON report has its schema;
4. the tier-1 gate: the port lints clean — zero unsuppressed findings
   over ``netrep_tpu_torch/`` with all rules active.
"""

import json
import subprocess
import sys

import pytest

from netrep_tpu.analysis import lint_source as jax_lint_source
from netrep_tpu_torch.analysis import default_rules, lint_paths, lint_source
from netrep_tpu_torch.analysis.linter import SYNTAX_RULE, package_root
from netrep_tpu_torch.analysis.rules import Module, RngDiscipline

RULE_NAMES = tuple(r.name for r in default_rules())


def findings_by_rule(report):
    out = {}
    for f in report.findings:
        out.setdefault(f.rule, []).append(f)
    return out


# ---------------------------------------------------------------------------
# per-rule violating fixtures — every rule must fire
# ---------------------------------------------------------------------------

RNG_BAD = """\
from netrep_tpu_torch import random as trandom

def chunk_keys(seed):
    key = trandom.key(seed)
    return trandom.split(key, 4)
"""

RNG_RELATIVE_BAD = """\
from .. import random as trandom
from ..random import split

def chunk_keys(seed):
    return split(trandom.key(seed), 4)
"""

RNG_TORCH_BAD = """\
import torch

def jitter(x, n):
    torch.manual_seed(0)
    g = torch.Generator()
    x.uniform_()
    return torch.randperm(n, generator=g) + torch.rand(n)
"""

RNG_HOST_BAD = """\
import time
import numpy as np

def jitter():
    return np.random.default_rng().random() + time.time()
"""

RNG_STDLIB_BAD = """\
import random

def pick(xs):
    return random.choice(xs)
"""

RNG_OK = """\
from .. import random as trandom

def perm(key, i, pool, start, count, words):
    k = trandom.fold_in(key, i)
    keys = trandom.perm_keys(key, start, count)
    again = trandom.ThreefryKey.from_data(keys.data())
    return trandom.permutation(k, pool), trandom.ThreefryKey(words), again
"""

EXC_BAD = """\
def f(work):
    try:
        work()
    except Exception:
        pass
"""

EXC_OK_RERAISE = """\
def f(work, pool, key):
    try:
        work()
    except BaseException:
        pool.discard(key)
        raise
"""

EXC_OK_CLASSIFY = """\
from netrep_tpu_torch.utils.faults import classify_error

def f(work):
    try:
        work()
    except Exception as e:
        classify_error(e)
"""

TEL_BAD = """\
def f(tel):
    tel.emit("definitely_not_a_registered_event", n=1)
"""

TEL_END_SPAN_BAD = """\
def f(tel, sid):
    tel.end_span(sid, "bogus_run_end", s=1.0)
"""

TEL_OK = """\
def f(tel, sid):
    tel.emit("chunk", perms=64)
    tel.end_span(sid, "null_run_end", s=1.0)
"""

SPAN_BAD = """\
def run(tel):
    sid = tel.begin_span("null_run_start", n_perm=64)
    work()
"""

SPAN_BAD_CLASS = """\
class Server:
    def boot(self, tel):
        self._sid = tel.begin_span("serve_start")
"""

SPAN_OK = """\
def run(tel):
    sid = tel.begin_span("null_run_start", n_perm=64)
    work()
    tel.end_span(sid, "null_run_end", s=1.0)
"""

SPAN_OK_CLASS_HANDOFF = """\
class Server:
    def boot(self, tel):
        self.tel = tel
        self._sid = tel.begin_span("serve_start")

    def close(self):
        self.tel.end_span(self._sid, "serve_end", s=1.0)
"""

CKPT_BAD_PREFIX = """\
from netrep_tpu_torch.utils.checkpoint import save_null_checkpoint

def save(path, nulls, kd, fp):
    save_null_checkpoint(path, nulls, 4, kd, fp,
                         extra={"x_tallies": nulls})
"""

CKPT_BAD_RESERVED = """\
from netrep_tpu_torch.utils.checkpoint import save_null_checkpoint

def save(path, nulls, kd, fp):
    save_null_checkpoint(path, nulls, 4, kd, fp,
                         extra={"completed": nulls})
"""

CKPT_OK = """\
from netrep_tpu_torch.utils.checkpoint import save_null_checkpoint

def save(path, nulls, kd, fp):
    save_null_checkpoint(path, nulls, 4, kd, fp,
                         extra={"stream_hi": nulls})
"""

RUNKEY_BAD = """\
class Eng:
    def run_key(self):
        return f"{self.device}|{self.stat_mode}|chunk:{self.config.chunk}"
"""

RUNKEY_OK = """\
class Eng:
    def run_key(self):
        caps = ",".join(str(b.cap) for b in self._buckets_full)
        mode = "data-only" if self.data_only else self.stat_mode
        return (f"{mode}+{self.config.dtype}|caps:{caps}"
                f"|chunk:{self.effective_chunk()}")
"""

RUNKEY_OK_DELEGATES = """\
class Packed(Base):
    def run_key(self):
        return f"{super().run_key()}|packed:{self.n_groups}"
"""

THREAD_BAD = """\
import threading

class Worker:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
        self._t = None

    def start(self):
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        self._n += 1

    def count(self):
        return self._n
"""

THREAD_OK_GUARDED = """\
import threading

class Worker:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
        self._t = None

    def start(self):
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        with self._lock:
            self._n += 1

    def count(self):
        with self._lock:
            return self._n
"""

THREAD_TRANSITIVE_BAD = """\
import threading

class Worker:
    def __init__(self):
        self._lock = threading.Lock()
        self._state = None
        self._t = None

    def start(self):
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        self._step()

    def _step(self):
        self._state = "running"

    def peek(self):
        return self._state
"""

IMPORT_BAD = """\
import jax
import jaxlib.xla_client as xc
from netrep_tpu.ops import oracle
from netrep_tpu import module_preservation
"""

IMPORT_OK = """\
import torch
from netrep_tpu_torch.ops import oracle
from ..ops import pvalues
from . import stats
"""

TF32_BAD = """\
import torch

def speed(flag):
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = flag
    torch.set_float32_matmul_precision("high")
"""

TF32_OK = """\
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
"""

FALLBACK_BAD = """\
import torch
from netrep_tpu_torch.ops import fused_stats as fs

def pick():
    return "cuda" if torch.cuda.is_available() else "cpu"

def many():
    if torch.cuda.device_count() == 0:
        return torch.device("cpu")
    return torch.device("cuda")

def values(*a):
    try:
        return fs.fused_stats_values(*a)
    except RuntimeError:
        return fs.fused_stats_values_plain(*a)

def run(x, device="cpu"):
    return x

class Engine:
    def __init__(self, x, *, device="cpu"):
        self.x = x
"""

FALLBACK_OK = """\
import torch

def resolve(device=None):
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' explicitly")
    return dev

def _helper(x, device="cpu"):
    return x

def values(fn, *a):
    try:
        return fn(*a)
    except RuntimeError:
        raise
"""


@pytest.mark.parametrize("rule,source,min_hits", [
    ("rng-discipline", RNG_BAD, 2),
    ("rng-discipline", RNG_RELATIVE_BAD, 2),
    ("rng-discipline", RNG_TORCH_BAD, 5),
    ("rng-discipline", RNG_HOST_BAD, 2),
    ("rng-discipline", RNG_STDLIB_BAD, 1),
    ("exception-taxonomy", EXC_BAD, 1),
    ("telemetry-registry", TEL_BAD, 1),
    ("telemetry-registry", TEL_END_SPAN_BAD, 1),
    ("span-pairing", SPAN_BAD, 1),
    ("span-pairing", SPAN_BAD_CLASS, 1),
    ("checkpoint-extras-namespace", CKPT_BAD_PREFIX, 1),
    ("checkpoint-extras-namespace", CKPT_BAD_RESERVED, 1),
    ("checkpoint-extras-namespace", RUNKEY_BAD, 1),
    ("thread-shared-state", THREAD_BAD, 2),
    ("port-imports", IMPORT_BAD, 4),
    ("tf32-off", TF32_BAD, 3),
    ("no-device-fallback", FALLBACK_BAD, 5),
])
def test_rule_fires_on_violating_fixture(rule, source, min_hits):
    report = lint_source(source)
    hits = findings_by_rule(report).get(rule, [])
    assert len(hits) >= min_hits, report.render()
    # the finding carries a real location, not a placeholder
    assert all(f.line >= 1 and f.path for f in hits)
    assert not report.ok


@pytest.mark.parametrize("source", [
    RNG_OK, EXC_OK_RERAISE, EXC_OK_CLASSIFY, TEL_OK, SPAN_OK,
    SPAN_OK_CLASS_HANDOFF, CKPT_OK, RUNKEY_OK, RUNKEY_OK_DELEGATES,
    THREAD_OK_GUARDED, IMPORT_OK, TF32_OK, FALLBACK_OK,
])
def test_compliant_fixture_is_clean(source):
    report = lint_source(source)
    assert report.ok, report.render()


def test_run_key_names_the_missing_fields():
    report = lint_source(RUNKEY_BAD)
    (hit,) = findings_by_rule(report)["checkpoint-extras-namespace"]
    for field in ("dtype", "buckets", "data_only"):
        assert field in hit.message
    assert "stat_mode" not in hit.message.split("[")[1]


def test_thread_rule_sees_through_helper_calls():
    """A helper invoked from the worker loop executes on the worker
    thread — the transitive-closure half of the lightweight analysis."""
    report = lint_source(THREAD_TRANSITIVE_BAD)
    hits = findings_by_rule(report).get("thread-shared-state", [])
    assert hits, report.render()


# ---------------------------------------------------------------------------
# the rules shared with the JAX package give its findings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule,source", [
    ("exception-taxonomy", EXC_BAD),
    ("exception-taxonomy", EXC_OK_RERAISE),
    ("exception-taxonomy", EXC_OK_CLASSIFY),
    ("span-pairing", SPAN_BAD),
    ("span-pairing", SPAN_BAD_CLASS),
    ("span-pairing", SPAN_OK_CLASS_HANDOFF),
    ("thread-shared-state", THREAD_BAD),
    ("thread-shared-state", THREAD_TRANSITIVE_BAD),
    ("thread-shared-state", THREAD_OK_GUARDED),
    ("checkpoint-extras-namespace", CKPT_BAD_PREFIX),
    ("checkpoint-extras-namespace", CKPT_BAD_RESERVED),
    ("checkpoint-extras-namespace", CKPT_OK),
])
def test_shared_rules_equal_jax(rule, source):
    def rows(report):
        return [(f.rule, f.line, f.message) for f in report.findings]

    assert rows(lint_source(source, rule_names=[rule])) == rows(
        jax_lint_source(source, rule_names=[rule]))


# ---------------------------------------------------------------------------
# suppressions: honored, tallied, reason-required
# ---------------------------------------------------------------------------

def _suppress(source: str, rule: str, reason="fixture-sanctioned site"):
    """Suffix every line that would produce a finding with an allow
    comment (same-line form)."""
    base = lint_source(source)
    lines = source.splitlines()
    for f in base.findings:
        if f.rule == rule:
            lines[f.line - 1] += f"  # netrep: allow({rule}) — {reason}"
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("rule,source", [
    ("rng-discipline", RNG_BAD),
    ("exception-taxonomy", EXC_BAD),
    ("telemetry-registry", TEL_BAD),
    ("span-pairing", SPAN_BAD),
    ("checkpoint-extras-namespace", CKPT_BAD_PREFIX),
    ("thread-shared-state", THREAD_BAD),
    ("port-imports", IMPORT_BAD),
    ("tf32-off", TF32_BAD),
    ("no-device-fallback", FALLBACK_BAD),
])
def test_suppression_honored_and_tallied(rule, source):
    suppressed_src = _suppress(source, rule)
    report = lint_source(suppressed_src)
    assert report.ok, report.render()
    assert len(report.suppressed) >= 1
    assert all(f.rule == rule for f in report.suppressed)
    # tallied: every honored suppression records its use count + reason
    used = [s for s in report.suppressions if s.used]
    assert used and all(s.reason for s in used)
    assert not report.stale


def test_suppression_comment_above_finding_line():
    src = EXC_BAD.replace(
        "    except Exception:",
        "    # netrep: allow(exception-taxonomy) — fixture: error is "
        "rethrown by the caller\n    except Exception:",
    )
    report = lint_source(src)
    assert report.ok, report.render()
    assert len(report.suppressed) == 1


def test_suppression_without_reason_is_a_finding():
    src = EXC_BAD.replace(
        "    except Exception:",
        "    except Exception:  # netrep: allow(exception-taxonomy)",
    )
    report = lint_source(src)
    rules = {f.rule for f in report.findings}
    # the reasonless allow is flagged AND does not silence the original
    assert SYNTAX_RULE in rules and "exception-taxonomy" in rules


def test_suppression_in_docstring_is_ignored():
    src = (
        '"""Docs may show the grammar: # netrep: allow(x) — reason."""\n'
        "VALUE = 1\n"
    )
    report = lint_source(src)
    assert report.ok, report.render()
    assert not report.suppressions


def test_stale_suppression_reported_not_fatal():
    src = "# netrep: allow(rng-discipline) — nothing here violates it\n" \
          "VALUE = 1\n"
    report = lint_source(src)
    assert report.ok
    assert len(report.stale) == 1


def test_rule_filter_and_unknown_rule():
    report = lint_source(RNG_BAD, rule_names=["tf32-off"])
    assert report.ok  # rng rule inactive, the tf32 rule has nothing
    with pytest.raises(ValueError, match="unknown rule"):
        lint_paths(rule_names=["not-a-rule"])
    # the JAX package's donation-alias has no meaning in PyTorch
    with pytest.raises(ValueError, match="unknown rule"):
        lint_paths(rule_names=["donation-alias"])


# ---------------------------------------------------------------------------
# scoping: rng-discipline applies to fixtures and to the null path
# ---------------------------------------------------------------------------

def test_rng_scope_limits_to_null_path_subpackages():
    rule = RngDiscipline()
    src = "import time\nT = time.time()\n"
    in_scope = Module("engine.py", src, pkg_rel="parallel/engine.py")
    out_scope = Module("journal.py", src, pkg_rel="serve/journal.py")
    fixture = Module("x.py", src, pkg_rel=None)
    assert rule.check(in_scope) and rule.check(fixture)
    assert not rule.check(out_scope)


def test_rng_scope_on_the_real_files():
    # serve/journal.py stamps records with time.time(): outside the null
    # path; parallel/engine.py's only draws carry reasoned suppressions
    import os

    root = package_root()
    journal = lint_paths([os.path.join(root, "serve", "journal.py")],
                         rule_names=["rng-discipline"])
    assert journal.ok and not journal.suppressed
    with open(os.path.join(root, "serve", "journal.py")) as f:
        assert "time.time()" in f.read()
    engine = lint_paths([os.path.join(root, "parallel", "engine.py")],
                        rule_names=["rng-discipline"])
    assert engine.ok and len(engine.suppressed) == 2


def test_package_root_is_the_port():
    import os

    assert os.path.basename(package_root()) == "netrep_tpu_torch"


# ---------------------------------------------------------------------------
# the tier-1 gate: the port lints clean
# ---------------------------------------------------------------------------

def test_port_lints_clean_with_all_rules():
    report = lint_paths()
    assert set(report.rules) == set(RULE_NAMES) and len(RULE_NAMES) == 9
    assert report.ok, "\n" + report.render()
    # every inline suppression carries a reason
    assert report.suppressions, "expected sanctioned sites to be tallied"
    assert all(s.reason.strip() for s in report.suppressions)
    # and none of them is stale (a fixed violation must drop its comment)
    assert not report.stale, "\n" + report.render()


def test_json_schema_equals_jax():
    port = lint_source(EXC_BAD).to_json()
    jax = jax_lint_source(EXC_BAD).to_json()
    assert port.keys() == jax.keys() and port["lint_v"] == jax["lint_v"] == 1
    assert port["findings"][0].keys() == jax["findings"][0].keys()


def _cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", "netrep_tpu_torch", "lint", *argv],
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": "/tmp"},
        cwd=__import__("os").path.dirname(package_root()))


def test_cli_lint_json_schema():
    out = _cli("--json")
    assert out.returncode == 0, out.stdout + out.stderr
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert row["lint_v"] == 1 and row["ok"] is True
    assert set(RULE_NAMES) <= set(row["rules"])
    assert row["findings"] == []
    assert row["suppressions"]


def test_cli_lint_exit_2_on_findings(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(FALLBACK_BAD)
    out = _cli(str(bad))
    assert out.returncode == 2, out.stdout + out.stderr
    assert "no-device-fallback" in out.stdout

"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level name (``netrep_tpu_torch`` is not ``netrep_tpu``); the
reference imports nothing of the port; and a run checks ``sys.modules``."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import core

from .conftest import ROOT

PB = ROOT / "portbench"
SOURCES = sorted(p for p in PB.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_forbidden_import(path):
    assert not top_level_imports(path) & set(core.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = top_level_imports(path)
    assert "netrep_tpu_torch" not in names and not names & set(core.FORBIDDEN)


def test_whole_name_comparison(monkeypatch):
    monkeypatch.setitem(sys.modules, "netrep_tpu_torch_fake", object())
    assert "netrep_tpu" not in core.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert core.forbidden_loaded() == ["jaxlib"]


def test_a_run_loads_no_forbidden_module(tmp_path):
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from portbench.tests.conftest import run_small\n"
        "out = run_small('dense20k.null100k', 3)\n"
        "from portbench import core\n"
        "assert out['correct'] and not core.forbidden_loaded(), core.forbidden_loaded()\n"
        "import netrep_tpu_torch.models.sparse_api, portbench.reference.check\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in core.FORBIDDEN))\n"
    ) % str(ROOT)
    env = dict(os.environ, NETREP_AUTOTUNE_STORE=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"

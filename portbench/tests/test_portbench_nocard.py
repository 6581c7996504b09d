"""The harness refuses to run without a card: a non-zero exit and no result
line; it never falls back to the CPU."""

import os
import subprocess
import sys

from .conftest import ROOT


def test_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", TMPDIR=str(tmp_path))
    r = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "dense20k.null100k",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 2
    assert r.stdout.strip() == ""
    assert "CUDA device" in r.stderr

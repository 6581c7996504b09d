"""Shared pieces of the benchmark's own tests. Whether a card is present is
decided inside the ``card`` fixture, never while a module is imported."""

import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.fixture
def isolated(monkeypatch, tmp_path):
    """The environment a run sets: an empty autotune store of its own."""
    monkeypatch.setenv("NETREP_AUTOTUNE_STORE", str(tmp_path / "autotune"))
    monkeypatch.delenv("NETREP_FAULT_PLAN", raising=False)
    return tmp_path


def shrink(f):
    """Cut a cell to a size the CPU runs in seconds (tests only)."""
    cfg, traffic = f["config"], f["traffic"]
    if cfg["kind"] == "dense":
        cfg.update(genes=300, samples=16, modules=4, module_size_range=[8, 24])
    else:
        cfg.update(nodes=1200, k=8, samples=16, modules=4, module_size_range=[10, 50])
    cfg["engine"] = dict(cfg["engine"], chunk_size=32)
    traffic.update(n_perm=320, warm_perms=32)


def run_small(workload, seed, device="cpu", trace=False, control=False,
              seconds=0.3, extra=None):
    from portbench import core

    def adjust(f):
        shrink(f)
        if extra:
            extra(f)

    return core.run_cell(ROOT, workload, seed, seconds, trace, device,
                         time.perf_counter(), adjust=adjust, control=control)

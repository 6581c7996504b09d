"""``correct`` on small cells run on the CPU through the whole harness
(only the look for a card is skipped): true for the port as it is; false
with the timed path broken underneath (a count or a value altered where
it is produced; half of each chunk's permutations left out); and the control,
the reference in TF32, above the cells' limits on every seed tried."""

import pytest
import torch

from .conftest import run_small

CELLS = ["dense20k.null100k", "knn50k.call10k"]


def assert_judged(out, correct):
    assert out["correct"] is correct, out["checks"]
    assert list(out)[-1] == "checks"
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("workload", CELLS)
def test_sound_port_is_correct(workload, isolated):
    out = run_small(workload, 2**31 + 12345)
    assert_judged(out, True)
    assert out["failed"] == 0 and out["attempted"] >= 1


@pytest.mark.parametrize("workload", CELLS)
def test_half_the_batch_left_out_is_not_correct(workload, isolated, monkeypatch):
    from netrep_tpu_torch import random as trandom

    draw = trandom.permutation

    def half(k, x):
        out = draw(k, x)
        if out.ndim == 2 and out.shape[0] > 1:
            b = out.shape[0]
            out = torch.cat([out[:b - b // 2], out[:b // 2]])
        return out

    monkeypatch.setattr(trandom, "permutation", half)

    def deeper(f):
        # counts move by about the square root of the permutations left
        # out: at 320 a call the fault reads near the counts' limit
        f["traffic"]["n_perm"] = 3200

    assert_judged(run_small(workload, 424242, extra=deeper), False)


def test_altered_count_is_not_correct(isolated, monkeypatch):
    from netrep_tpu_torch.parallel import engine

    counts = engine.fused_stats_counts

    def altered(*a, **kw):
        vals, hi, lo, eff = counts(*a, **kw)
        hi = hi.clone()
        hi[0, 1] += 40
        return vals, hi, lo, eff

    monkeypatch.setattr(engine, "fused_stats_counts", altered)
    out = run_small("dense20k.null100k", 78)
    assert_judged(out, False)
    assert out["checks"]["count_gap"]["value"] > out["checks"]["count_gap"]["limit"]


def test_altered_sparse_value_is_not_correct(isolated, monkeypatch):
    from netrep_tpu_torch.ops import sparse

    stats = sparse.sparse_gather_and_stats

    def altered(*a, **kw):
        out = stats(*a, **kw)
        if out.ndim == 3:  # a null chunk, not the observed pass
            out[0, 0, 1] += 0.05
        return out

    monkeypatch.setattr(sparse, "sparse_gather_and_stats", altered)
    assert_judged(run_small("knn50k.call10k", 79), False)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [5, 2**31 + 7, 909])
def test_control_fails_a_limit(workload, seed, isolated):
    out = run_small(workload, seed, control=True)
    ctrl, checks = out["control"], out["checks"]
    assert any(ctrl[k] > checks[k]["limit"] for k in checks), (ctrl, checks)


@pytest.mark.gpu
def test_sound_port_is_correct_on_the_card(card, isolated):
    assert_judged(run_small("dense20k.null100k", 31, device=card), True)

"""The window arithmetic of ``call_s`` and ``perms_per_s``, on a fake
clock."""

import pytest

from portbench.drivers import calls


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def fake_call(clock, seconds, n_perm):
    """A call lasting ``seconds``."""
    def call(i):
        clock.t += seconds
        return {"n_perm": n_perm}
    return call


def test_window_holds_whole_calls():
    clock = Clock()
    w = calls.drive(fake_call(clock, 3.0, 10_000), 10.0, clock, lambda: None, lambda: 7)
    # calls end at 3, 6, 9, 12: the fourth is the first to end after 10 s
    assert len(w.calls) == 4 and w.seconds == pytest.approx(12.0)
    e2e = calls.end_to_end(w)
    assert e2e["call_s"] == pytest.approx(3.0)
    assert e2e["perms_per_s"] == pytest.approx(40_000 / 12.0)
    assert w.peak_bytes == 7 and w.failed == 0


def test_a_call_longer_than_the_window_is_the_window():
    clock = Clock()
    w = calls.drive(fake_call(clock, 14.0, 100_000), 10.0, clock, lambda: None,
                    lambda: 1)
    assert len(w.calls) == 1 and w.seconds == pytest.approx(14.0)
    assert calls.end_to_end(w)["perms_per_s"] == pytest.approx(100_000 / 14.0)


def test_calls_numbered_from_first():
    clock = Clock()
    w = calls.drive(fake_call(clock, 4.0, 10), 5.0, clock, lambda: None, lambda: 0,
                    first=3)
    assert [c["index"] for c in w.calls] == [3, 4]


def test_failed_calls_are_counted():
    clock = Clock()

    def call(i):
        clock.t += 2.0
        if i == 1:
            raise ValueError("broken")
        return {"n_perm": 10}

    w = calls.drive(call, 5.0, clock, lambda: None, lambda: 0)
    assert w.failed == 1 and len(w.calls) == 3
    assert w.perms == 20

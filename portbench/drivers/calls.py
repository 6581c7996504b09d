"""``driver: calls`` — a closed loop: one analyst or pipeline starting the
next call as soon as the last returns, for ``--seconds``. The window
closes at the end of the first call that ends after ``--seconds``, so it
holds whole calls: ``call_s`` is its length over its calls, and
``perms_per_s`` the permutations of its calls over its length.
"""

from __future__ import annotations

import dataclasses
import traceback
from typing import Callable


@dataclasses.dataclass
class Window:
    start: float
    end: float
    calls: list
    perms: int
    peak_bytes: int | None
    failed: int

    @property
    def seconds(self) -> float:
        return self.end - self.start


def drive(call: Callable, seconds: float, clock: Callable, on_open: Callable,
          on_close: Callable, first: int = 0) -> Window:
    """Run calls back to back. ``call(index)`` returns a record with
    ``n_perm``; ``on_open()`` runs as the window opens, ``on_close()`` as it
    closes and returns the peak device bytes. Calls are numbered from
    ``first``."""
    calls = []
    on_open()
    start = clock()
    i = first
    while True:
        rec = {"index": i, "t0": clock()}
        try:
            rec.update(call(i))
        except Exception:  # a failed call is counted and the loop goes on
            rec["error"] = traceback.format_exc(limit=4)
        rec["t1"] = clock()
        calls.append(rec)
        i += 1
        if rec["t1"] - start >= seconds:
            break
    end = calls[-1]["t1"]
    perms = sum(c.get("n_perm", 0) for c in calls if "error" not in c)
    return Window(start, end, calls, perms, on_close(),
                  sum("error" in c for c in calls))


def end_to_end(w: Window) -> dict:
    """The window's end-to-end numbers: seconds per call over the whole
    window, permutations per second, in the window's own terms."""
    return {"call_s": w.seconds / len(w.calls),
            "perms_per_s": w.perms / w.seconds}

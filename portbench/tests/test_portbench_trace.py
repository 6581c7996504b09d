"""Idle share and roofline share on a synthetic trace."""

import types

import pytest

from portbench import costcount, readers, trace


def ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def synthetic():
    return [
        ev(trace.OPEN, "user_annotation", 1000.0, 0.0),
        ev("void fused_stats_kernel<float>(float const*)", "kernel", 900.0, 300.0,
           grid=[640, 1, 1]),  # 200 us inside the window
        ev("void fused_stats_kernel<float>(float const*)", "kernel", 1400.0, 100.0,
           grid=[640, 1, 1]),
        ev("Memcpy DtoH", "gpu_memcpy", 1450.0, 100.0),  # overlaps: 50 new
        ev("aten::item", "cpu_op", 1600.0, 300.0),
        ev(trace.CLOSE, "user_annotation", 2000.0, 0.0),
        ev("after", "kernel", 2100.0, 50.0),
    ]


def test_busy_and_idle_share():
    s = trace.summarize(synthetic())
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx(350e-6)
    view = types.SimpleNamespace(trace=s)
    assert readers.idle_share(view) == pytest.approx(65.0)
    k = s["kernels"]["fused_stats_kernel<float>"]
    assert k["launches"] == 2 and k["blocks"] == 1280
    assert k["seconds"] == pytest.approx(300e-6)
    # the longest idle gap, 1550..2000 us, has the host in aten::item
    assert s["breakdown"]["idle_gaps"][0][0] == "cpu_op:aten::item"


def test_card_window_bounded_by_marker_kernels():
    events = [e for e in synthetic() if e["cat"] != "user_annotation"]
    events += [ev("void at::cuda::spin_kernel(long)", "kernel", 1000.0, 5.0),
               ev("void at::cuda::spin_kernel(long)", "kernel", 1995.0, 5.0)]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx(350e-6)  # the markers are not work
    assert not any("spin" in n for n in s["kernels"])


def test_trace_that_lost_a_marker_spans_its_device_events():
    s = trace.summarize([e for e in synthetic() if e["name"] != trace.CLOSE])
    # from the first kernel's start (900) to the last event's end (2150)
    assert s["bounded_by"] == "events"
    assert s["window_s"] == pytest.approx(1250e-6)
    assert s["busy_s"] == pytest.approx(500e-6)


def test_trace_without_device_events_reads_nothing():
    host = [e for e in synthetic() if e["cat"] in ("cpu_op", "user_annotation")
            and e["name"] != trace.CLOSE]
    assert trace.summarize(host) is None


def test_roofline_share():
    shape = {"sizes": [30, 50], "samples": 128, "power_iters": 60, "n_mats": 2,
             "width": 4, "chunk": 128}
    s = trace.summarize(synthetic())
    view = types.SimpleNamespace(trace=s, cost_shape=shape, card="NVIDIA H100 80GB HBM3",
                                 traffic={"options": {}})
    got = readers.roofline_share(view, "fused_stats_kernel", counting=False)
    flops, nbytes = costcount.per_perm(shape, False)
    least = 640 * max(flops / 67e12, nbytes / 3.35e12)  # 1280 blocks / 2 modules
    assert got == pytest.approx(100.0 * least / 300e-6)
    # the counting metric reads nothing in a cell that keeps its null
    assert readers.roofline_share(view, "fused_stats_kernel", counting=True) is None
    view.card = "some other card"
    assert readers.roofline_share(view, "fused_stats_kernel", counting=False) is None


def test_union_and_gaps():
    assert trace.union([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]

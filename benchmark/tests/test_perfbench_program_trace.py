"""The readers of the program's own spans and counters on a synthetic run:
the stage metrics from given spans and kernel intervals (their sum the
request's host time), ``padding_share`` from the frame counters,
``k2_roofline`` at or below 100% on a window of idle launches; each gives
nothing for a program that records no spans or counters; and K2's counts
held to ``chip_smoke.w_bound``."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import program_trace  # noqa: E402
from benchmark.harness import Run, Trace, load_reader  # noqa: E402
from benchmark.yardstick import PEAK_BYTES, bound_s  # noqa: E402
from benchmark.yardstick_k2 import k2_counts  # noqa: E402

STAGES = ("prep", "launch", "fetch", "emit")
F, R_A, M_A = 513, 50, 100


def _run(span, requests, kernels, lanes=64, t0=0.0, t1=20.0):
    cell = SimpleNamespace(
        config={"bases": {"f": F}, "program": {}},
        params={"adapt": {"r_a": R_A, "m_a": M_A}}, traffic={})
    driver = SimpleNamespace(span=span, lanes=lanes, t0=t0, t1=t1)
    names = [n for n, _, _ in kernels]
    trace = Trace(names, np.asarray([a for _, a, _ in kernels], float),
                  np.asarray([b for _, _, b in kernels], float))
    return Run(cell, driver, {}, [(span, a, b) for a, b in requests], trace)


def _program(monkeypatch, spans=None, counters=None):
    monkeypatch.setattr(program_trace, "program_spans", lambda: spans)
    monkeypatch.setattr(program_trace, "program_counters", lambda: counters)


# two calls of 10 s; the kernels [5, 8] and [16, 17]
CALLS = [(0.0, 10.0), (10.0, 20.0)]
KERNELS = [("k", 5.0, 8.0), ("k", 16.0, 17.0)]
SPANS = {"prep": [(0, 4), (10, 13)], "launch": [(4, 6), (13, 15)],
         "fetch": [(6, 9), (15, 19)], "emit": [(9, 10), (19, 20)]}
WANT = {"prep": 3.5, "launch": 1.5, "fetch": 2.0, "emit": 1.0}


@pytest.mark.parametrize("kind,prefix", [("batch", "batch"),
                                         ("request", "stream")])
def test_stage_metrics_from_spans_and_kernel_intervals(monkeypatch, kind,
                                                       prefix):
    spans = [(f"{prefix}.{st}", float(a), float(b))
             for st in STAGES for a, b in SPANS[st]]
    spans.append((f"{prefix}.prep", 25.0, 26.0))        # after the window
    spans.append(("runner.enhance", 0.0, 20.0))         # another span
    _program(monkeypatch, spans=spans)
    request = "enhance_batch" if kind == "batch" else "fleet.push"
    run = _run(request, CALLS, KERNELS)
    got = {st: load_reader(f"{kind}_{st}_ms")(run) for st in STAGES}
    assert got == pytest.approx({st: v * 1e3 for st, v in WANT.items()})
    host = load_reader(f"{kind}_host_ms")(run)
    assert sum(got.values()) == pytest.approx(host)


def test_padding_share_from_the_frame_counters(monkeypatch):
    _program(monkeypatch, counters={"batch.frames_true": 64 * 347,
                                    "batch.frames_computed": 64 * 352})
    run = _run("enhance_batch", CALLS, KERNELS)
    assert load_reader("padding_share")(run) == pytest.approx(100 * 5 / 352)


def test_k2_roofline_at_or_below_100_on_idle_launches(monkeypatch):
    lanes, n = 200, 10
    # every lane inactive: each launch reads and writes W0, flag and trips
    one = 4.0 * lanes * (2 * F * R_A + 2) / PEAK_BYTES
    _program(monkeypatch, counters={"k2.lane_trips": 0,
                                    "k2.active_lanes": 0})
    for took, want in ((one, 100.0), (2 * one, 50.0), (20e-6, None)):
        kernels = [("void (anonymous namespace)::w_lanes_kernel(float)",
                    1.0 + i, 1.0 + i + took) for i in range(n)]
        kernels.append(("h_narrow_kernel", 0.5, 0.6))
        kernels.append(("w_lanes_kernel", 30.0, 30.1))  # after the window
        run = _run("fleet.push", [(0.0, 20.0)], kernels, lanes=lanes)
        got = load_reader("k2_roofline")(run)
        assert 0.0 < got <= 100.0 + 1e-9
        if want is not None:
            assert got == pytest.approx(want)


def test_the_k2_counts_of_a_launch_with_active_and_idle_lanes():
    flops, n_bytes = k2_counts(F, R_A, M_A, lane_trips=30, active=2,
                               lane_launches=5)
    assert flops == 4.0 * F * R_A * M_A * 30
    assert n_bytes == 4.0 * (2 * (F * M_A + 2 * F * R_A + R_A * M_A)
                             + 3 * 2 * F * R_A + 2 * 5)


def test_k2_counts_are_the_smoke_scripts():
    import chip_smoke
    b = 64
    v = torch.zeros((b, F, M_A))
    trips = torch.arange(b, dtype=torch.int32) % 23
    ms, by = chip_smoke.w_bound(v, R_A, trips)
    flops, n_bytes = k2_counts(F, R_A, M_A, int(trips.sum()), b, b)
    assert ms == pytest.approx(bound_s(flops, n_bytes) * 1e3, rel=1e-12)
    assert by == ("operations" if flops / 67e12 >= n_bytes / PEAK_BYTES
                  else "bytes")


@pytest.mark.parametrize("name", [f"{k}_{st}_ms" for k in ("batch", "request")
                                  for st in STAGES]
                         + ["padding_share", "k2_roofline"])
def test_nothing_from_a_program_without_spans_or_counters(monkeypatch,
                                                          name):
    monkeypatch.setattr(program_trace, "_profiling", lambda: object())
    run = _run("fleet.push", CALLS, KERNELS + [("w_lanes_kernel", 1, 2)])
    assert load_reader(name)(run) is None

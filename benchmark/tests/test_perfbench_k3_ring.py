"""``k3_ring_wait_share`` from K3's ring counters: the share of the chunks
taken that had not landed, and nothing for a program that does not count
them (one without the counters, or with no chunk in the session)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import load_reader  # noqa: E402
from benchmark.tests.test_perfbench_program_trace import (  # noqa: E402
    CALLS, KERNELS, _program, _run)

K3 = {"k3.columns": 24576, "k3.column_trips": 636000}


@pytest.mark.parametrize("counters,want", [
    ({**K3, "k3.ring_chunks": 1000, "k3.ring_waits": 25}, 2.5),
    ({**K3, "k3.ring_chunks": 800, "k3.ring_waits": 800}, 100.0),
    ({**K3, "k3.ring_chunks": 4096, "k3.ring_waits": 0}, 0.0),
    ({**K3, "k3.ring_chunks": 0, "k3.ring_waits": 0}, None),
    (K3, None),
    ({}, None),
    (None, None),
])
def test_k3_ring_wait_share_from_the_ring_counters(monkeypatch, counters,
                                                   want):
    _program(monkeypatch, counters=counters)
    got = load_reader("k3_ring_wait_share")(_run("enhance_batch", CALLS,
                                                 KERNELS))
    assert got == (want if want is None else pytest.approx(want))

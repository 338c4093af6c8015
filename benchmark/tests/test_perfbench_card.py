"""On the card (``gpu``-marked; skipped without one): a small run of each
cell through the card's kernels, traced, is correct and reads its per-layer
metrics, and the TF32 control is not correct.  Run on the card with

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu \
        benchmark/tests/test_perfbench_card.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import compare  # noqa: E402
from benchmark.harness import run_cell, spec  # noqa: E402
from benchmark.tests.small import SMALL  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_small_traced_run_on_the_card(card, cell):
    result, lines = run_cell(cell, 2 ** 31 + 99, 1.0, True,
                             traffic=SMALL[cell], control=True)
    assert result["correct"], lines
    ok, _ = compare.judge(result["control"], compare.limits(cell))
    assert not ok, lines
    names = {m["name"] for m in spec()["per_layer"]
             if cell in m["workloads"]}
    assert set(result["metrics"]) == names
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]

"""Each cell's pieces end to end on the CPU at a small size: the run is
correct; the control (the reference in bfloat16 in the program's place)
is not; and a run whose timed path is broken underneath is not, for each
fault the cell can have."""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import compare  # noqa: E402
from benchmark.harness import run_cell, spec  # noqa: E402
from benchmark.tests.small import SMALL  # noqa: E402

SEED = 2 ** 31 + 12345          # more than 32 signed bits hold


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell, control=False):
    seconds = 1.0 if SMALL[cell]["driver"] == "stream" else 0.3
    return run_cell(cell, SEED, seconds, False, device="cpu",
                    traffic=SMALL[cell], control=control)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_small_run_is_correct_and_prints_the_contract_keys(cell):
    result, lines = _run(cell)
    assert result["correct"], lines
    assert list(result)[-1] == "checks"
    assert set(result) >= {"correct", "attempted", "failed", "metrics",
                           "device"}
    bench = spec()
    want = {m["name"] for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == want
    assert all(math.isfinite(m["value"]) and m["value"] > 0
               for m in result["metrics"].values())
    assert result["attempted"] > 0 and result["failed"] == 0
    json.dumps(result)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_bfloat16_control_is_not_correct(cell):
    result, lines = _run(cell, control=True)
    ok, _ = compare.judge(result["control"], compare.limits(cell))
    assert result["correct"] and not ok, lines


def _state_unchanged(monkeypatch, cell):
    if cell.startswith("nat_block88"):
        from se_snmf_nat_tpu_torch.stream.block_adaptive import BlockStep
        orig = BlockStep.eager

        def eager(self, state, ring_ptr, *args):
            _, _, xm = orig(self, state, ring_ptr, *args)
            return state, ring_ptr, xm
        monkeypatch.setattr(BlockStep, "eager", eager)
    else:
        from se_snmf_nat_tpu_torch.enhance.engine import Engine
        orig = Engine.step

        def step(self, state, ym, l):
            _, out = orig(self, state, ym, l)
            return state, out
        monkeypatch.setattr(Engine, "step", step)


def _refit_returns_its_input(monkeypatch, cell):
    """The W-only refit of the adapted noise columns (K2 on the card, the
    plain solver here) hands back the columns it was given."""
    if cell.startswith("nat_block88"):
        from se_snmf_nat_tpu_torch.stream import block_adaptive as mod
        orig = mod.mu_w_solve_lanes

        def solve(target, w0, *args, **kwargs):
            return (w0,) + tuple(orig(target, w0, *args, **kwargs)[1:])
        monkeypatch.setattr(mod, "mu_w_solve_lanes", solve)
    else:
        from se_snmf_nat_tpu_torch.enhance.engine import Engine

        def refit(self, target, w0, h0a, r_up, active):
            return w0
        monkeypatch.setattr(Engine, "_refit", refit)


def _outputs(monkeypatch, cell, alter):
    """Patch the entry the window drives so that ``alter`` changes what it
    returns: a list of lanes (``enhance_batch``), a (lanes, n) array (a
    fleet's push) or one lane's samples (a session's push)."""
    if cell.startswith("nat_block88"):
        from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer as cls
        name = "enhance_batch"
    elif cell == "nat_frame.fleet":
        from se_snmf_nat_tpu_torch.stream.serving import (
            MultiStreamSession as cls)
        name = "push"
    else:
        from se_snmf_nat_tpu_torch.stream.streaming import (
            StreamingSession as cls)
        name = "push"
    orig = getattr(cls, name)

    def patched(self, *args, **kwargs):
        return alter(orig(self, *args, **kwargs))
    monkeypatch.setattr(cls, name, patched)


def _half_left_out(out):
    half = len(out) // 2
    if isinstance(out, list):
        return out[:half] + [np.zeros_like(y) for y in out[half:]]
    out = out.copy()
    out[half:] = 0
    return out


def _answer_altered(out):
    """One utterance answered with another's samples; a fleet tick's answer
    handed to the wrong lanes; a session's hop negated."""
    if isinstance(out, list):
        return [out[1]] + out[1:]
    return np.roll(out, 1, axis=0) if out.ndim == 2 else -out


FAULTS = [(c, f) for c in sorted(SMALL)
          for f in ("state_unchanged", "refit_returns_its_input",
                    "half_left_out", "answer_altered")
          if not (c == "nat_frame.mic" and f == "half_left_out")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    if fault == "state_unchanged":
        _state_unchanged(monkeypatch, cell)
    elif fault == "refit_returns_its_input":
        _refit_returns_its_input(monkeypatch, cell)
    else:
        _outputs(monkeypatch, cell, {"half_left_out": _half_left_out,
                                     "answer_altered": _answer_altered}[fault])
    result, lines = _run(cell)
    assert not result["correct"], lines
    if fault == "refit_returns_its_input" and cell.startswith("nat_frame"):
        assert any(line.startswith("not compared") and "refits" in line
                   for line in lines), lines

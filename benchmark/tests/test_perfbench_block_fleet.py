"""The configuration ``nat_block8`` (the block-adaptive serving fleet), its
cell ``nat_block8.fleet`` and the cell ``nat_block88.batch16`` on the CPU
at a small size: a run of each is correct and reports its end-to-end
metrics; its bfloat16 control is not correct, nor are the faults planted
(a lane zeroed, the refit returning its input); the fleet's driver refuses
a traffic that is not the configuration's block on the frames wire; every
name the new entries give resolves to its file; the two readers of the
block counters on a synthetic run; and neither cell loads JAX or the JAX
package."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import compare  # noqa: E402
from benchmark.harness import Cell, load_reader, run_cell, spec  # noqa: E402
from benchmark.tests.test_perfbench_program_trace import (  # noqa: E402
    CALLS, KERNELS, _program, _run as _synthetic_run)

SEED = 2 ** 31 + 4242          # more than 32 signed bits hold
FLEET, BATCH = "nat_block8.fleet", "nat_block88.batch16"
SMALL = {
    FLEET: {"driver": "stream_block", "api": "fleet", "lanes": 4,
            "block_frames": 8, "wire": "frames", "tick_hops": 8,
            "utterance_samples": 8000, "warmup_ticks": 2, "check_lanes": 4,
            "check_frames": 48},
    BATCH: {"driver": "batch", "lanes": 3, "pool": 6,
            "lengths": {"samples": 16000}, "warmup_calls": 1,
            "check_calls": 2},
}
METRICS = {FLEET: {"latency_ms_p50", "setup_s"},
           BATCH: {"audio_s_per_s", "setup_s"}}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell, control=False, traffic=None):
    seconds = 1.0 if cell == FLEET else 0.3
    return run_cell(cell, SEED, seconds, False, device="cpu",
                    traffic=traffic or SMALL[cell], control=control)


@pytest.mark.parametrize("cell", [FLEET, BATCH])
def test_a_small_run_is_correct_and_reports_its_metrics(cell):
    result, lines = _run(cell)
    assert result["correct"], lines
    assert set(result["metrics"]) == METRICS[cell]
    assert set(result["checks"]) == set(compare.limits(cell))
    assert result["attempted"] > 0 and result["failed"] == 0
    if cell == FLEET:
        assert any(line.startswith("not compared: refits") for line in lines)
    json.dumps(result)


@pytest.mark.parametrize("cell", [FLEET, BATCH])
def test_the_bfloat16_control_is_not_correct(cell):
    result, lines = _run(cell, control=True)
    ok, _ = compare.judge(result["control"], compare.limits(cell))
    assert result["correct"] and not ok, lines


def _lane_zeroed(monkeypatch, cell):
    if cell == FLEET:
        from se_snmf_nat_tpu_torch.stream.serving import (
            MultiStreamSession as cls)
        name = "push"
    else:
        from se_snmf_nat_tpu_torch.stream.pipeline import (
            SnmfEnhancer as cls)
        name = "enhance_batch"
    orig = getattr(cls, name)

    def patched(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        if isinstance(out, list):
            return [np.zeros_like(out[0])] + out[1:]
        out = out.copy()
        out[0] = 0
        return out
    monkeypatch.setattr(cls, name, patched)


def _refit_returns_its_input(monkeypatch):
    """The block step's W-only refit (K2 on the card, its plain version
    here) hands back the columns it was given."""
    from se_snmf_nat_tpu_torch.stream import block_adaptive as mod
    orig = mod.mu_w_solve_lanes

    def solve(target, w0, *args, **kwargs):
        return (w0,) + tuple(orig(target, w0, *args, **kwargs)[1:])
    monkeypatch.setattr(mod, "mu_w_solve_lanes", solve)


@pytest.mark.parametrize("cell", [FLEET, BATCH])
@pytest.mark.parametrize("fault", ["lane_zeroed", "refit_returns_its_input"])
def test_a_planted_fault_is_not_correct(monkeypatch, cell, fault):
    if fault == "lane_zeroed":
        _lane_zeroed(monkeypatch, cell)
    else:
        _refit_returns_its_input(monkeypatch)
    result, lines = _run(cell)
    assert not result["correct"], lines


@pytest.mark.parametrize("change", [{"block_frames": 16},
                                    {"wire": "samples"},
                                    {"api": "session"}])
def test_the_fleet_driver_refuses_another_block_or_wire(change):
    cell = Cell(FLEET, SEED, torch.device("cpu"),
                traffic=dict(SMALL[FLEET], **change))
    with pytest.raises(ValueError):
        cell.driver()


def test_every_new_name_resolves():
    bench = spec()
    bench_dir = ROOT / "benchmark"
    cells = {w["name"]: w for w in bench["workloads"]}
    assert len(cells) == 9 and all(w["chips"] == 1
                                   for w in cells.values())
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == "nat_block8")
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    assert cfg["name"] == "nat_block8" and cfg_entry["reduced"] == []
    assert cfg["reference"] == "snmf_nat_session"
    assert (bench_dir / "reference" / "snmf_nat_session.py").exists()
    assert (bench_dir / "programs" / f"{cfg['builder']}.py").exists()
    block88 = json.loads((bench_dir / "configs" / "nat_block88.json")
                         .read_text())
    for key in ("algorithm", "bases", "precision", "assumed"):
        assert cfg[key] == block88[key], key
    for name, config, traffic, driver in (
            (FLEET, "nat_block8", "fleet_block8", "stream_block"),
            (BATCH, "nat_block88", "block16", "batch")):
        w = cells[name]
        assert (w["config"], w["traffic"]) == (config, traffic)
        t = json.loads((bench_dir / "traffic" / f"{traffic}.json")
                       .read_text())
        assert t["driver"] == driver
        assert "class Driver" in (bench_dir / "drivers"
                                  / f"{driver}.py").read_text()
        assert set(compare.limits(name)) <= {"err_median", "err_q75",
                                             "err_max"}
        ends = {m["name"] for m in bench["end_to_end"]
                if name in m.get("workloads", [name])}
        assert ends == METRICS[name]
    fleet = json.loads((bench_dir / "traffic" / "fleet_block8.json")
                       .read_text())
    assert fleet["block_frames"] == cfg["session"]["block_frames"]
    assert fleet["check_frames"] % fleet["block_frames"] == 0
    assert fleet["lanes"] % 8 == 0
    layers = {m["name"]: m for m in bench["per_layer"]}
    for name in ("block_graph_share.stream", "block_tick_kernels"):
        m = layers[name]
        assert (bench_dir / "metrics" / f"{name}.py").exists()
        assert m["moves"] == "latency_ms_p50"
        assert m["workloads"] == [FLEET]
    for m in bench["per_layer"]:
        w = m.get("workloads", [])
        assert ("nat_block88.batch64" in w) == (BATCH in w), m["name"]


@pytest.mark.parametrize("counters,want", [
    ({"block.steps": 500, "block.steps_graphed": 500}, 100.0),
    ({"block.steps": 500, "block.steps_graphed": 499}, 99.8),
    ({"block.steps": 4}, 0.0),
    ({"frame.steps": 48, "frame.steps_graphed": 48}, None),
    ({"block.steps": 0, "block.steps_graphed": 0}, None),
    (None, None),
])
def test_the_block_graph_share_from_the_block_counters(monkeypatch, counters,
                                                       want):
    _program(monkeypatch, counters=counters)
    got = load_reader("block_graph_share.stream")(
        _synthetic_run("fleet.push", CALLS, KERNELS))
    assert got == (want if want is None else pytest.approx(want))


@pytest.mark.parametrize("counters,want", [
    ({"block.steps": 2}, 1.0),
    ({"block.steps": 1}, 2.0),
    ({"frame.steps": 16}, None),
    (None, None),
])
def test_block_tick_kernels_counts_the_kernels_a_block(monkeypatch, counters,
                                                       want):
    _program(monkeypatch, counters=counters)
    got = load_reader("block_tick_kernels")(
        _synthetic_run("fleet.push", CALLS, KERNELS))
    assert got == want


def test_neither_cell_loads_jax_nor_the_jax_package():
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(2)
from benchmark.harness import forbidden_modules, run_cell
from benchmark.tests.test_perfbench_block_fleet import SMALL
for cell, traffic in SMALL.items():
    run_cell(cell, 3, 0.2, False, device="cpu", traffic=traffic)
import benchmark.reference.snmf_nat_session, benchmark.drivers.stream_block
print(json.dumps(forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_session_reference_loads_nothing_of_the_program():
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(2)
from benchmark.reference import snmf_nat_session
from benchmark.traffic import inputs
cfg = json.load(open({str(ROOT / "benchmark/configs/nat_block8.json")!r}))
x = inputs.noisy_utterances([2560, 2560], 1, "cpu")
snmf_nat_session.live(x, 16, cfg, inputs.structured_bases(seed=1))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "se_snmf_nat_tpu",
                       "se_snmf_nat_tpu_torch"}
